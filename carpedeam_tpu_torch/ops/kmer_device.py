"""kmermatcher on the card: the overlap prefilter as tensor programs and
three CUDA kernels (csrc/kmer_windows.cu, csrc/kmer_select.cu,
csrc/seg_scan.cu).

Port of carpedeam_tpu/ops/kmer_tpu.py (its `kmermatcher_device`, :657),
bit-identical to the host kmermatcher (kmer/matcher.py), stage by stage
in the same order:

  1. per length bucket: the identity hash of each row and every k-mer
     window (pack, canonicalise, xxh64, strand) -- kernel A
     (`kmer_windows`; plain versions `identity_hash_reference`,
     `windows_bucket_reference`);
  2. the per-row stable sort by (h16, kmer, pos) -- torch.sort;
  3. the subsampling walk of kmermatcher.cpp:226-350 over each sorted
     row -- kernel B (`select_walk`; plain `select_bucket_reference`);
  4. compaction and the flat (wA, wB2) table -- tensor ops;
  5. the global stable sort, the group -> centre assignment and the
     (centre, member, diagonal) sort -- torch.sort, cumsum gathers;
  6. the per-(centre, member) best-diagonal lookahead, whose segmented
     suffix scans run in kernel C (`seg_suffix_scan`; plain
     `tiled_suffix_scan_reference`);
  7. the final PrefDB row order by exclusive-cumsum destinations.

torch has no usable uint64, so every unsigned 64-bit word lives in an
int64 tensor: products wrap as XXH64 needs, a logical right shift is an
arithmetic one masked (`_srl`), and a sort or compare on an unsigned word
flips its sign bit first (`_ukey`).  The kernels use uint64_t.  A wrapper
runs the plain version when its tensors lie on the CPU and launches its
kernel on CUDA tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from .._build import KERNELS
from ..aligndb import PrefDB
from ..constants import CHAR_TO_CODE
from ..utils import LEN_BUCKET

I64 = torch.int64
ALL1 = -1                       # 0xFFFF_FFFF_FFFF_FFFF as int64
SIGN = -(1 << 63)               # the sign bit as int64

# global packing widths: id < 2^B_ID, sequence length < 2^B_LEN
B_ID = 21
B_LEN = 19
LMAX = (1 << B_LEN) - 1

KMER_WINDOWS = KERNELS["kmer_windows"]
KMER_SELECT = KERNELS["kmer_select"]
SEG_SCAN = KERNELS["seg_suffix_scan"]

# kernel C's two combines, and the elements of one of its tiles
# (csrc/seg_scan.cu kTile)
SCAN_ARGMAX = 0
SCAN_OR = 1
SEG_SCAN_TILE = 4096


def _s64(v: int) -> int:
    """An unsigned 64-bit constant as the int64 with the same bits."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= (1 << 63) else v


_P1 = _s64(0x9E3779B185EBCA87)
_P2 = _s64(0xC2B2AE3D27D4EB4F)
_P3 = _s64(0x165667B19E3779F9)
_P4 = _s64(0x85EBCA77C2B2AE63)
_P5 = 0x27D4EB2F165667C5


def _srl(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift of the 64-bit words in x by r (1 <= r <= 63)."""
    return (x >> r) & ((1 << (64 - r)) - 1)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | _srl(x, 64 - r)


def _ukey(x: torch.Tensor) -> torch.Tensor:
    """x with its sign bit flipped: signed order of the result is the
    unsigned order of x."""
    return x ^ SIGN


def xxh64_u64(v: torch.Tensor, seed: int) -> torch.Tensor:
    """XXH64 of each 8-byte word of v (int64 bits) with `seed`
    (kmer/xxh64.xxh64_u64; carpedeam_tpu/ops/kmer_tpu.py:88)."""
    k1 = _rotl(v * _P2, 31) * _P1
    acc = _s64(_P5 + seed + 8) ^ k1
    acc = _rotl(acc, 27) * _P1 + _P4
    acc = acc ^ _srl(acc, 33)
    acc = acc * _P2
    acc = acc ^ _srl(acc, 29)
    acc = acc * _P3
    return acc ^ _srl(acc, 32)


def revcomp(idx: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of packed k-mers (Util.cpp:601-640;
    carpedeam_tpu/ops/kmer_tpu.py:101)."""
    x = idx ^ _s64(0xAAAAAAAAAAAAAAAA)
    m2, m4 = 0x3333333333333333, 0x0F0F0F0F0F0F0F0F
    mb1, mb2 = 0x00FF00FF00FF00FF, 0x0000FFFF0000FFFF
    x = (_srl(x, 2) & m2) | ((x & m2) << 2)
    x = (_srl(x, 4) & m4) | ((x & m4) << 4)
    x = (_srl(x, 8) & mb1) | ((x & mb1) << 8)
    x = (_srl(x, 16) & mb2) | ((x & mb2) << 16)
    x = _srl(x, 32) | (x << 32)
    return _srl(x, 64 - 2 * k)


def _u32_bits(x: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of x as int32 (uint32 bits in a signed tensor)."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def _u32(x: torch.Tensor) -> torch.Tensor:
    """uint32 bits held in an int32 tensor -> their value as int64."""
    return x.to(I64) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# stage 1: kernel A and its plain versions
# ---------------------------------------------------------------------------

def identity_hash_reference(codes: torch.Tensor, lengths: torch.Tensor,
                            hash_shift: int) -> torch.Tensor:
    """Util::hash h = h*31 + code over each row's true length, then xxh64
    (carpedeam_tpu/ops/kmer_tpu.py:121): a loop over columns."""
    B, L = codes.shape
    c64 = codes.to(I64)
    lens = lengths.to(I64)
    h = torch.zeros(B, dtype=I64, device=codes.device)
    for col in range(L):
        h = torch.where(col < lens, h * 31 + c64[:, col], h)
    return xxh64_u64(h, hash_shift)


def windows_bucket_reference(codes: torch.Tensor, lengths: torch.Tensor,
                             k: int, hash_shift: int):
    """Every window of every row: pack, canonicalise, hash,
    strand-resolve (carpedeam_tpu/ops/kmer_tpu.py:138).

    Returns (key2 (B, W) int64, pos_strand (B, W) int32): key2 =
    (h16 << 2k) | canonical k-mer, ALL1 for a window that is not kept;
    pos_strand = uint32 bits of (pos_f << 1) | fwd."""
    B, L = codes.shape
    W = L - k + 1
    dev = codes.device
    c64 = codes.to(I64)
    lens = lengths.to(I64)
    kmer = torch.zeros((B, W), dtype=I64, device=dev)
    for j in range(k):
        kmer = (kmer << 2) | c64[:, j:j + W]
    isx = (codes > 3).to(I64)
    csum = torch.cat([torch.zeros((B, 1), dtype=I64, device=dev),
                      torch.cumsum(isx, dim=1)], dim=1)
    no_x = (csum[:, k:] - csum[:, :-k]) == 0
    pos = torch.arange(W, dtype=I64, device=dev)[None, :]
    inside = pos + k <= lens[:, None]

    rc = revcomp(kmer, k)
    palin = rc == kmer
    pick_rev = _ukey(rc) < _ukey(kmer)
    canon = torch.where(pick_rev, rc, kmer)
    keep = no_x & inside & ~palin
    pos_f = torch.where(pick_rev, lens[:, None] - pos - k, pos)
    h16 = xxh64_u64(canon, hash_shift) & 0xFFFF
    key2 = torch.where(keep, (h16 << (2 * k)) | canon,
                       torch.full_like(canon, ALL1))
    fwd = torch.where(pick_rev, 0, 1)
    pos_strand = _u32_bits(((pos_f & 0xFFFFFFFF) << 1) | fwd)
    return key2, pos_strand


def kmer_windows(codes: torch.Tensor, lengths: torch.Tensor, k: int,
                 hash_shift: int):
    """Kernel A: (id_hash (B,) int64, key2 (B, W) int64, pos_strand (B, W)
    int32) of a (B, L) uint8 code plane (codes 0-3, 4 for X and padding)
    and its (B,) int32 true lengths; W = L - k + 1 (0 when L < k: only
    the identity hash)."""
    if codes.dtype != torch.uint8 or codes.dim() != 2 \
            or not codes.is_contiguous():
        raise TypeError("codes must be a contiguous (B, L) uint8 plane")
    if lengths.dtype != torch.int32 or lengths.shape != codes.shape[:1] \
            or lengths.device != codes.device:
        raise TypeError("lengths must be (B,) int32 on the codes' device")
    if not 1 <= k <= 31:
        raise ValueError(f"k={k} outside 1..31")
    B, L = codes.shape
    W = max(L - k + 1, 0)
    if codes.device.type == "cpu":
        id_hash = identity_hash_reference(codes, lengths, hash_shift)
        if W == 0:
            return (id_hash, torch.zeros((B, 0), dtype=I64),
                    torch.zeros((B, 0), dtype=torch.int32))
        return (id_hash, *windows_bucket_reference(codes, lengths, k,
                                                   hash_shift))
    id_hash = torch.empty(B, dtype=I64, device=codes.device)
    key2 = torch.empty((B, W), dtype=I64, device=codes.device)
    ps = torch.empty((B, W), dtype=torch.int32, device=codes.device)
    KMER_WINDOWS.launch(codes.data_ptr(), lengths.data_ptr(), B, L, k,
                        hash_shift, id_hash.data_ptr(), key2.data_ptr(),
                        ps.data_ptr(),
                        torch.cuda.current_stream(codes.device).cuda_stream)
    return id_hash, key2, ps


# ---------------------------------------------------------------------------
# stage 2: per-row sort
# ---------------------------------------------------------------------------

def rowsort_bucket(key2: torch.Tensor, pos_strand: torch.Tensor):
    """Per-row stable sort by (h16, kmer, pos_f), invalid windows last
    (carpedeam_tpu/ops/kmer_tpu.py:172): two LSD passes, pos_f then
    key2."""
    _, perm1 = torch.sort(_u32(pos_strand) >> 1, dim=1, stable=True)
    key2p = torch.gather(key2, 1, perm1)
    _, p2 = torch.sort(_ukey(key2p), dim=1, stable=True)
    perm = torch.gather(perm1, 1, p2)
    return torch.gather(key2p, 1, p2), torch.gather(pos_strand, 1, perm)


# ---------------------------------------------------------------------------
# stage 3: kernel B and its plain version
# ---------------------------------------------------------------------------

def considered_count(lengths: torch.Tensor, kmers_per_sequence: int,
                     kmers_per_sequence_scale: float) -> torch.Tensor:
    """int(f32(kps - 1) + f32(scale) * f32(len)), as the JAX package
    computes it (multiply, then add, each rounded to f32)."""
    a = torch.tensor(kmers_per_sequence - 1, dtype=torch.float32,
                     device=lengths.device)
    s = torch.tensor(kmers_per_sequence_scale, dtype=torch.float32,
                     device=lengths.device)
    return (a + s * lengths.to(torch.float32)).to(I64)


def select_bucket_reference(key2s: torch.Tensor, lengths: torch.Tensor,
                            k: int, kmers_per_sequence: int,
                            kmers_per_sequence_scale: float) -> torch.Tensor:
    """The subsampling walk (kmermatcher.cpp:226-350) over hash-sorted
    rows (carpedeam_tpu/ops/kmer_tpu.py:190): (B, W) bool hits, a loop
    over columns of row-vector ops.

    The reference's 65536-bin histogram threshold collapses to
    `threshold = sorted_hash[considered-1] + 1` and `too_much =
    rank(threshold) - considered`."""
    B, W = key2s.shape
    dev = key2s.device
    keep_s = key2s != ALL1
    h16 = torch.where(keep_s, _srl(key2s, 2 * k),
                      torch.full_like(key2s, 65536))
    valid_cnt = keep_s.to(I64).sum(dim=1)
    considered = torch.minimum(
        considered_count(lengths, kmers_per_sequence,
                         kmers_per_sequence_scale), valid_cnt)
    gi = torch.clamp(considered - 1, 0, W - 1)
    t_hash = torch.gather(h16, 1, gi[:, None])[:, 0]
    zero = torch.zeros_like(considered)
    thr = torch.where(considered > 0, t_hash + 1, zero)
    rank = (h16 < thr[:, None]).to(I64).sum(dim=1)
    too_much = torch.where(considered > 0, rank - considered, zero)

    # a run of equal masked k-mers met at the cursor is skipped and the
    # first different element is processed unconditionally (key2 equality
    # == masked-kmer equality: h16 is a function of the k-mer)
    no = torch.zeros((B, 1), dtype=torch.bool, device=dev)
    eq_next = torch.cat([(key2s[:, 1:] == key2s[:, :-1]) & keep_s[:, 1:],
                         no], dim=1)
    eq_prev = torch.cat([no, eq_next[:, :-1]], dim=1)

    in_skip = torch.zeros(B, dtype=torch.bool, device=dev)
    sel = torch.zeros(B, dtype=I64, device=dev)
    hits = torch.empty((B, W), dtype=torch.bool, device=dev)
    for c in range(W):
        h, nxt, prv, vld = h16[:, c], eq_next[:, c], eq_prev[:, c], \
            keep_s[:, c]
        landed = in_skip & ~prv
        enter_skip = ~in_skip & nxt
        process = (landed | (~in_skip & ~nxt)) & vld & (sel < considered)
        hit = process & (h < thr)
        is_tm = hit & (h == thr - 1) & (too_much != 0)
        too_much = torch.where(is_tm, too_much - 1, too_much)
        thr = torch.where(is_tm & (too_much == 0), thr - 1, thr)
        sel = sel + hit.to(I64)
        in_skip = (in_skip & prv) | enter_skip
        hits[:, c] = hit
    return hits


def select_walk(key2s: torch.Tensor, lengths: torch.Tensor, k: int,
                kmers_per_sequence: int,
                kmers_per_sequence_scale: float) -> torch.Tensor:
    """Kernel B: (B, W) bool hits of the subsampling walk over the sorted
    (B, W) int64 rows `key2s`, (B,) int32 true lengths."""
    if key2s.dtype != I64 or key2s.dim() != 2 or not key2s.is_contiguous():
        raise TypeError("key2s must be a contiguous (B, W) int64 tensor")
    if lengths.dtype != torch.int32 or lengths.shape != key2s.shape[:1] \
            or lengths.device != key2s.device:
        raise TypeError("lengths must be (B,) int32 on key2s' device")
    if key2s.device.type == "cpu":
        return select_bucket_reference(key2s, lengths, k,
                                       kmers_per_sequence,
                                       kmers_per_sequence_scale)
    B, W = key2s.shape
    hits = torch.empty((B, W), dtype=torch.bool, device=key2s.device)
    KMER_SELECT.launch(key2s.data_ptr(), lengths.data_ptr(), B, W, k,
                       kmers_per_sequence, float(kmers_per_sequence_scale),
                       hits.data_ptr(),
                       torch.cuda.current_stream(key2s.device).cuda_stream)
    return hits


# ---------------------------------------------------------------------------
# stage 4: compaction and the flat table
# ---------------------------------------------------------------------------

def compact_bucket(key2s, ps_s, hits):
    """Selected windows to the front columns, in order
    (carpedeam_tpu/ops/kmer_tpu.py:248)."""
    _, perm = torch.sort((~hits).to(torch.uint8), dim=1, stable=True)
    return (torch.gather(key2s, 1, perm), torch.gather(ps_s, 1, perm),
            hits.to(I64).sum(dim=1))


def flatten_bucket(key2c, psc, selcnt, ids, lengths, k: int):
    """Selected windows -> flat (wA, wB2) (carpedeam_tpu/ops/kmer_tpu.py:
    264): wA = masked k-mer; wB2 = ((LMAX - len) << 41) | (id << 20) |
    (pos_f << 1) | fwd; unselected -> ALL1."""
    W = key2c.shape[1]
    col = torch.arange(W, device=key2c.device)[None, :]
    sel = (col < selcnt[:, None]) & (key2c != ALL1)
    canon = key2c & ((1 << (2 * k)) - 1)
    wb2 = ((LMAX - lengths.to(I64))[:, None] << (B_ID + B_LEN + 1)) \
        | (ids.to(I64)[:, None] << (B_LEN + 1)) | _u32(psc)
    all1 = torch.full_like(canon, ALL1)
    return (torch.where(sel, canon, all1).reshape(-1),
            torch.where(sel, wb2, all1).reshape(-1))


def identity_rows(id_hash, ids, lengths):
    """Identity entries (carpedeam_tpu/ops/kmer_tpu.py:288): wA = hash
    without bit 63, strand bit = hash bit 63."""
    wa = id_hash & ((1 << 63) - 1)
    wb2 = ((LMAX - lengths.to(I64)) << (B_ID + B_LEN + 1)) \
        | (ids.to(I64) << (B_LEN + 1)) | _srl(id_hash, 63)
    return wa, wb2


# ---------------------------------------------------------------------------
# stage 5: global sort and group assignment
# ---------------------------------------------------------------------------

def global_sort(wa, wb2):
    """Stable sort by (masked k-mer, len desc, id, pos): two LSD passes;
    the strand bit (wB2 bit 0) is no key (carpedeam_tpu/ops/kmer_tpu.py:
    305)."""
    _, perm1 = torch.sort(_srl(wb2, 1), stable=True)
    wa1 = wa[perm1]
    _, p2 = torch.sort(_ukey(wa1), stable=True)
    return wa1[p2], wb2[perm1[p2]]


def assign_groups(wa_s, wb2_s, include_only_extendable: bool,
                  cov_mode: int, cov_thr: float):
    """assignGroup (kmermatcher.cpp:453-562; carpedeam_tpu/ops/kmer_tpu.py:
    322): per entry (centre, centre_fwd, member, diagonal, keep)."""
    M = wa_s.shape[0]
    dev = wa_s.device
    idx = torch.arange(M, dtype=I64, device=dev)
    valid = wa_s != ALL1

    def fields(w):
        return (w & 1, _srl(w, 1) & LMAX,
                _srl(w, B_LEN + 1) & ((1 << B_ID) - 1),
                LMAX - _srl(w, B_ID + B_LEN + 1))
    fwd, pos, ids, seq_len = fields(wb2_s)

    f1 = torch.zeros(1, dtype=torch.bool, device=dev)
    prev_same = torch.cat([f1, (wa_s[1:] == wa_s[:-1]) & valid[1:]
                           & valid[:-1]])
    new_group = ~prev_same
    next_new = torch.cat([new_group[1:], ~f1])
    keep = valid & ~(new_group & next_new)

    rep_idx = _last_set_at_or_before(new_group)
    rep_fwd, rep_pos, centre, rep_len = fields(wb2_s[rep_idx])
    rep_is_rev = rep_fwd == 0
    tgt_is_rev = fwd == 0
    q_pos = torch.where(tgt_is_rev, rep_len - 1 - rep_pos, rep_pos)
    t_pos_adj = torch.where(tgt_is_rev, seq_len - 1 - pos, pos)
    diagonal = q_pos - t_pos_adj

    if include_only_extendable:
        keep = keep & ((diagonal < 0) | (diagonal > (rep_len - seq_len)))
    elif np.float32(cov_thr) > 0:
        keep = keep & can_be_covered(cov_mode, cov_thr, rep_len, seq_len)
    return centre, ~(rep_is_rev ^ tgt_is_rev), ids, diagonal, keep


def can_be_covered(cov_mode: int, cov_thr: float, qlen, tlen):
    """Util::canBeCovered in f32 for a positive threshold (the host's
    kmer/matcher.can_be_covered, all six modes; the JAX device program
    keeps every pair under modes 3-5)."""
    q = qlen.to(torch.float32)
    t = tlen.to(torch.float32)
    thr = torch.tensor(cov_thr, dtype=torch.float32, device=q.device)
    if cov_mode == 0:
        return (q / t >= thr) & (t / q >= thr)
    if cov_mode == 1:
        return q / t >= thr
    if cov_mode == 2:
        return t / q >= thr
    if cov_mode == 3:
        return (t / q >= thr) & (t / q <= 1.0)
    if cov_mode == 4:
        return (q / t >= thr) & (q / t <= 1.0)
    if cov_mode == 5:
        return torch.minimum(q, t) / torch.maximum(q, t) >= thr
    return torch.ones_like(q, dtype=torch.bool)


def _last_set_at_or_before(flag: torch.Tensor) -> torch.Tensor:
    """Per i, the largest j <= i with flag[j] (flag[0] must be set): the
    JAX program's cummax of where(flag, idx, 0), as a cumsum and a gather
    (torch.cummax over one long row runs as a slow scan on the card)."""
    return torch.nonzero(flag).flatten()[torch.cumsum(flag.to(I64), 0) - 1]


def _first_set_at_or_after(flag: torch.Tensor) -> torch.Tensor:
    """Per i, the smallest j >= i with flag[j] (flag[-1] must be set): the
    JAX program's reversed cummin of where(flag, idx, INT32_MAX)."""
    f = flag.to(I64)
    return torch.nonzero(flag).flatten()[torch.cumsum(f, 0) - f]


def sort_pairs(keep, centre, member, diagonal, centre_fwd):
    """Stable sort of kept entries by (centre, member, diagonal)
    (carpedeam_tpu/ops/kmer_tpu.py:385)."""
    doff = 1 << B_LEN
    key = (centre << (B_ID + B_LEN + 1)) | (member << (B_LEN + 1)) \
        | (diagonal + doff)
    key = torch.where(keep, key, torch.full_like(key, ALL1))
    key_s, order = torch.sort(_ukey(key), stable=True)
    key_s = _ukey(key_s)
    return (key_s != ALL1, _srl(key_s, B_ID + B_LEN + 1),
            _srl(key_s, B_LEN + 1) & ((1 << B_ID) - 1),
            (key_s & ((1 << (B_LEN + 1)) - 1)) - doff, centre_fwd[order])


# ---------------------------------------------------------------------------
# stage 6: kernel C, its plain version, and the lookahead
# ---------------------------------------------------------------------------

def _combine(mode: int, a, b):
    """combine(accumulated later elements a, current element b) of the
    segmented suffix scans (carpedeam_tpu/ops/kmer_tpu.py:459, :537):
    ARGMAX elements are (s, j, flag), OR elements (v, flag)."""
    if mode == SCAN_ARGMAX:
        a_s, a_j, a_f = a
        b_s, b_j, b_f = b
        take_b = b_f | (b_s > a_s) | ((b_s == a_s) & (b_j > a_j))
        return (torch.where(take_b, b_s, a_s), torch.where(take_b, b_j, a_j),
                a_f | b_f)
    a_v, a_f = a
    b_v, b_f = b
    return (b_v | (a_v & ~b_f), a_f | b_f)


def _scan_identity(mode: int):
    """(identity values, dtypes) of the mode's elements."""
    if mode == SCAN_ARGMAX:
        return (-(2 ** 30), -1, False), (I64, I64, torch.bool)
    return (False, False), (torch.bool, torch.bool)


def tiled_suffix_scan_reference(mode: int, xs):
    """Inclusive segmented suffix scan, out_i = x_i (+) x_{i+1} (+) ...
    with combine(later, current), as the JAX package's two-level tiled
    scan (carpedeam_tpu/ops/kmer_tpu.py:404): intra-tile suffix scans
    over the tile columns, an exclusive suffix scan of the tile
    aggregates, then one combine per element.  `xs` is the mode's
    element tuple of (M,) tensors; the table is padded with identity
    elements to whole tiles.  Returns the scanned values without the
    flag: (s, j) under ARGMAX, (v,) under OR."""
    M = xs[0].shape[0]
    dev = xs[0].device
    ident, dtypes = _scan_identity(mode)
    b_bits = max((max(M, 2).bit_length() - 1) // 2, 1)
    B = 1 << b_bits
    NB = -(-M // B)
    tiles = [torch.cat([x.to(dt), torch.full((NB * B - M,), v, dtype=dt,
                                             device=dev)]).reshape(NB, B)
             for x, v, dt in zip(xs, ident, dtypes)]
    acc = tuple(torch.full((NB,), v, dtype=dt, device=dev)
                for v, dt in zip(ident, dtypes))
    suf = tuple(torch.empty((NB, B), dtype=dt, device=dev) for dt in dtypes)
    for c in range(B - 1, -1, -1):
        acc = _combine(mode, acc, tuple(x[:, c] for x in tiles))
        for out, a in zip(suf, acc):
            out[:, c] = a
    # exclusive suffix scan of the tile aggregates (later tiles only)
    carry = tuple(torch.full((), v, dtype=dt, device=dev)
                  for v, dt in zip(ident, dtypes))
    pre = tuple(torch.empty((NB,), dtype=dt, device=dev) for dt in dtypes)
    for t in range(NB - 1, -1, -1):
        for out, a in zip(pre, carry):
            out[t] = a
        carry = _combine(mode, carry, tuple(x[t, 0] for x in suf))
    out = _combine(mode, tuple(p[:, None].expand(NB, B) for p in pre), suf)
    return tuple(o.reshape(-1)[:M] for o in out[:-1])


def seg_suffix_scan(mode: int, *xs):
    """Kernel C: the segmented suffix scan of `mode` over (M,) tensors,
    ARGMAX: xs = (s int64, j int64, f bool) -> (s, j);
    OR: xs = (v bool, f bool) -> (v,);
    f marks the last element of each segment."""
    _, dtypes = _scan_identity(mode)
    if len(xs) != len(dtypes) or any(
            x.dtype != dt or x.dim() != 1 or x.shape != xs[0].shape
            or x.device != xs[0].device for x, dt in zip(xs, dtypes)):
        raise TypeError("expected (M,) tensors of "
                        + ", ".join(str(d) for d in dtypes)
                        + " on one device")
    if xs[0].device.type == "cpu":
        return tiled_suffix_scan_reference(mode, xs)
    M = xs[0].shape[0]
    xs = [x.contiguous() for x in xs]
    outs = [torch.empty_like(x) for x in xs[:-1]]
    # the single-pass scan's tile states: a ticket counter, then per tile
    # a status word and an aggregate
    tiles = max(-(-M // SEG_SCAN_TILE), 1)
    work = torch.zeros(1 + 3 * tiles, dtype=I64, device=xs[0].device)
    j_in = xs[1] if mode == SCAN_ARGMAX else xs[0]
    j_out = outs[1] if mode == SCAN_ARGMAX else outs[0]
    SEG_SCAN.launch(mode, xs[0].data_ptr(), j_in.data_ptr(),
                    xs[-1].data_ptr(), M, outs[0].data_ptr(),
                    j_out.data_ptr(), work.data_ptr(),
                    torch.cuda.current_stream(xs[0].device).cuda_stream)
    return tuple(outs)


def pair_scan(kept, centre, member, diagonal, fwd):
    """Per-(centre, member) lookahead (kmermatcher.cpp:841-929;
    carpedeam_tpu/ops/kmer_tpu.py:474), including the quirk that the
    look-ahead may run past the centre's group: member runs are not cut
    at centre changes."""
    M = centre.shape[0]
    dev = centre.device
    idx = torch.arange(M, dtype=I64, device=dev)
    m1 = torch.full((1,), -1, dtype=I64, device=dev)
    t1 = torch.ones(1, dtype=torch.bool, device=dev)
    prev_c = torch.cat([m1, centre[:-1]])
    prev_m = torch.cat([m1, member[:-1]])
    prev_d = torch.cat([m1, diagonal[:-1]])
    # the padding tail: member = -2 - idx, so no run continues into it
    member_eff = torch.where(kept, member, -2 - idx)
    prev_m_eff = torch.cat([m1, member_eff[:-1]])
    first = idx == 0
    new_pair = kept & ((centre != prev_c) | (member != prev_m) | first)
    member_new = (member_eff != prev_m_eff) | first
    diag_new = member_new | (diagonal != prev_d)

    run_start = _last_set_at_or_before(diag_new)
    next_member_new = torch.cat([member_new[1:], t1])
    mre = _first_set_at_or_after(next_member_new)      # member-run end
    s_cnt = idx - run_start + 1
    suf_s, suf_j = seg_suffix_scan(SCAN_ARGMAX, s_cnt, idx,
                                   next_member_new)

    dre = _first_set_at_or_after(torch.cat([diag_new[1:], t1]))
    partial_cnt = dre - idx + 1
    has_full = dre < mre
    nxt = torch.clamp(dre + 1, 0, M - 1)
    full_s = torch.where(has_full, suf_s[nxt], -1)
    full_j = torch.where(has_full, suf_j[nxt], -1)
    take_full = (full_s > partial_cnt) | ((full_s == partial_cnt)
                                          & (full_j > dre))
    best_j = torch.where(take_full, full_j, dre)
    best_diag = diagonal[best_j]
    best_rev = ~fwd[best_j]
    top = mre - idx + 1

    emit = new_pair & (member != centre)
    score = torch.where(best_rev, -top, top)
    diag16 = ((best_diag & 0xFFFF) ^ 0x8000) - 0x8000   # int16 truncation

    # self rows: one per centre block holding at least one emitted pair
    centre_new = kept & ((centre != prev_c) | first)
    centre_end = torch.cat([centre_new[1:], t1])
    blk_has_emit, = seg_suffix_scan(SCAN_OR, emit, centre_end)
    return {"emit": emit, "self_emit": centre_new & blk_has_emit,
            "centre": centre, "member": member, "score": score,
            "diag16": diag16}


# ---------------------------------------------------------------------------
# stage 7: final row order
# ---------------------------------------------------------------------------

def finalize(g, n_seqs: int):
    """Pair rows, self rows and missing-centre rows in the final PrefDB
    order (kmermatcher.cpp:815-930 + :716-729;
    carpedeam_tpu/ops/kmer_tpu.py:554-622): centres ascending, the self
    row first in each block, members ascending; sequences never written
    as a centre get a lone self row, appended in id order.  Returns host
    arrays (q, t, score, diag, is_self)."""
    emit, self_emit = g["emit"], g["self_emit"]
    dev = emit.device
    e_in = torch.cumsum(emit.to(I64), dim=0)
    s_in = torch.cumsum(self_emit.to(I64), dim=0)
    e_ex = e_in - emit.to(I64)
    total_block = int((e_in[-1] + s_in[-1]).item()) if len(emit) else 0
    has_centre = torch.zeros(n_seqs, dtype=torch.bool, device=dev)
    has_centre[g["centre"][self_emit]] = True
    missing = torch.nonzero(~has_centre).flatten()
    n_rows = total_block + missing.numel()

    q = torch.empty(n_rows, dtype=I64, device=dev)
    t = torch.empty(n_rows, dtype=I64, device=dev)
    score = torch.zeros(n_rows, dtype=I64, device=dev)
    diag = torch.zeros(n_rows, dtype=I64, device=dev)
    is_self = torch.ones(n_rows, dtype=torch.bool, device=dev)
    dest_e = (e_ex + s_in)[emit]
    q[dest_e] = g["centre"][emit]
    t[dest_e] = g["member"][emit]
    score[dest_e] = g["score"][emit]
    diag[dest_e] = g["diag16"][emit]
    is_self[dest_e] = False
    dest_s = (e_ex + s_in - 1)[self_emit]
    q[dest_s] = g["centre"][self_emit]
    t[dest_s] = g["centre"][self_emit]
    q[total_block:] = missing
    t[total_block:] = missing
    return tuple(x.cpu().numpy() for x in (q, t, score, diag, is_self))


# ---------------------------------------------------------------------------
# host driver
# ---------------------------------------------------------------------------

def bucketize(seqdb):
    """Sequence ids grouped by padded length bucket: [(bucket_len, ids)]
    (carpedeam_tpu/ops/kmer_tpu.py:642)."""
    lens = seqdb.lengths.astype(np.int64)
    b_of = np.maximum(LEN_BUCKET, -(-lens // LEN_BUCKET) * LEN_BUCKET)
    return [(int(b), np.nonzero(b_of == b)[0]) for b in np.unique(b_of)]


def code_plane(data: torch.Tensor, offsets: torch.Tensor,
               lengths: torch.Tensor, bl: int) -> torch.Tensor:
    """(B, bl) uint8 code plane (CHAR_TO_CODE; 4 for X and padding) of
    the rows at `offsets` / `lengths` of the flat sequence bytes `data`,
    built on their device."""
    col = torch.arange(bl, dtype=I64, device=data.device)[None, :]
    inside = col < lengths.to(I64)[:, None]
    idx = torch.where(inside, offsets.to(I64)[:, None] + col, 0)
    lut = torch.from_numpy(CHAR_TO_CODE).to(data.device)
    return torch.where(inside, lut[data[idx].to(I64)],
                       torch.tensor(4, dtype=torch.uint8, device=data.device))


def kmermatcher_device(seqdb, k: int, kmers_per_sequence: int,
                       kmers_per_sequence_scale: float,
                       include_only_extendable: bool, hash_shift: int = 67,
                       cov_mode: int = 0, cov_thr: float = 0.0,
                       device="cuda") -> PrefDB:
    """The kmermatcher stage on `device` -> PrefDB, bit-identical to
    kmer.matcher.kmermatcher.  Raises ValueError (the JAX package's
    packing budget) at 2^21 sequences or more, or a sequence of 2^19
    bases or more; the pipeline then takes the host path."""
    from ..utils import resolve_device
    n_seqs = len(seqdb)
    if n_seqs == 0:
        return PrefDB(qkey=np.zeros(0, np.uint32),
                      tkey=np.zeros(0, np.uint32),
                      score=np.zeros(0, np.int32), diag=np.zeros(0, np.int32),
                      starts=np.zeros(1, np.int64),
                      qkeys=np.zeros(0, np.uint32), qext=np.zeros(0, bool))
    if n_seqs >= (1 << B_ID):
        raise ValueError(f"kmermatcher_device: {n_seqs} sequences exceeds "
                         f"the 2^{B_ID} packing budget; shard first")
    if int(seqdb.lengths.max(initial=0)) >= (1 << B_LEN):
        raise ValueError("kmermatcher_device: sequence length exceeds "
                         f"the 2^{B_LEN} packing budget")
    dev = resolve_device(device)

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # (one byte at least: the padding of a zero-length row reads index 0)
    data_d = on(seqdb.data if len(seqdb.data) else np.zeros(1, np.uint8))
    was, wb2s = [], []
    for bl, ids_np in bucketize(seqdb):
        ids_d = on(ids_np)
        lens_d = on(seqdb.lengths[ids_np].astype(np.int32))
        codes_d = code_plane(data_d, on(seqdb.offsets[ids_np]), lens_d, bl)
        id_hash, key2, pos_strand = kmer_windows(codes_d, lens_d, k,
                                                 hash_shift)
        wa_i, wb2_i = identity_rows(id_hash, ids_d, lens_d)
        was.append(wa_i)
        wb2s.append(wb2_i)
        if bl < k:
            continue
        key2s, ps_s = rowsort_bucket(key2, pos_strand)
        del key2, pos_strand
        hits = select_walk(key2s, lens_d, k, kmers_per_sequence,
                           kmers_per_sequence_scale)
        W = key2s.shape[1]
        # nothing beyond `considered` can be selected
        cap = int(np.float32(kmers_per_sequence - 1)
                  + np.float32(kmers_per_sequence_scale)
                  * np.float32(bl)) + 1
        if cap < W // 2:
            # compaction: the flat table scales with the selected count
            key2c, psc, selcnt = compact_bucket(key2s, ps_s, hits)
            key2c, psc = key2c[:, :cap], psc[:, :cap]
        else:
            key2c = torch.where(hits, key2s, torch.full_like(key2s, ALL1))
            psc = ps_s
            selcnt = torch.full((key2s.shape[0],), W, dtype=I64, device=dev)
        wa_w, wb2_w = flatten_bucket(key2c, psc, selcnt, ids_d, lens_d, k)
        was.append(wa_w)
        wb2s.append(wb2_w)

    wa_s, wb2_s = global_sort(torch.cat(was), torch.cat(wb2s))
    del was, wb2s
    centre, centre_fwd, member, diagonal, keep = assign_groups(
        wa_s, wb2_s, bool(include_only_extendable), int(cov_mode),
        float(cov_thr))
    del wa_s, wb2_s
    g = pair_scan(*sort_pairs(keep, centre, member, diagonal, centre_fwd))
    q, t, score, diag, is_self = finalize(g, n_seqs)
    del g

    keys = seqdb.keys
    qkey = keys[q].astype(np.uint32)
    tkey = keys[t].astype(np.uint32)
    n_rows = len(q)
    # a new centre block starts with its self row
    starts = np.concatenate([np.nonzero(is_self)[0], [n_rows]]).astype(
        np.int64)
    out_qkeys = qkey[is_self]
    # ext flag: True only for missing-centre passthrough rows of extended
    # sequences (kmermatcher.cpp:716-729)
    lone = (starts[1:] - starts[:-1]) == 1
    qext = np.zeros(len(out_qkeys), dtype=bool)
    qext[lone] = seqdb.ext[q[is_self][lone]]
    return PrefDB(qkey=qkey, tkey=tkey, score=score.astype(np.int32),
                  diag=diag.astype(np.int32), starts=starts,
                  qkeys=out_qkeys, qext=qext)
