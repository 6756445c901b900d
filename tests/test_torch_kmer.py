"""The port's device kmermatcher (ops/kmer_device.py) on the CPU, where
its kernels run their plain PyTorch versions, against the JAX package's
device kmermatcher (ops/kmer_tpu.py) and its host kmermatcher: whole
PrefDBs on read-phase, contig-like and edge-case DBs, and each plain
kernel version against the JAX stage function it replaces."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carpedeam_tpu.kmer.matcher import kmermatcher as jax_kmermatcher
from carpedeam_tpu.ops import kmer_tpu as J
from carpedeam_tpu_torch.constants import CHAR_TO_CODE
from carpedeam_tpu_torch.kmer import packing, xxh64
from carpedeam_tpu_torch.kmer.matcher import kmermatcher
from carpedeam_tpu_torch.ops import kmer_device as K
from torch_port_util import contig_db, reads_world, to_jax_db

import chip_smoke

PREF_COLUMNS = chip_smoke.PREF_COLUMNS


def assert_prefdb_equal(a, b):
    for c in PREF_COLUMNS:
        x, y = np.asarray(getattr(a, c)), np.asarray(getattr(b, c))
        assert x.shape == y.shape, (c, x.shape, y.shape)
        assert (x == y).all(), (c, np.nonzero(x != y)[0][:5])


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def _db(kind: str):
    if kind == "reads":
        return reads_world(71, 2000)[0]
    if kind == "contigs":
        db = contig_db(72, 200, 150, 900, 40_000)
        db.ext[::4] = True
        return db
    return chip_smoke.kmer_edge_db(np.random.default_rng(73))


@pytest.mark.parametrize("kind, k, only_ext", [
    ("reads", 20, False), ("contigs", 22, True), ("edges", 20, False),
    ("edges", 22, True)])
def test_kmermatcher_device_matches_jax_and_host(kind, k, only_ext):
    """Read-phase reads (k=20), contig-like sequences up to 900 bases
    (k=22, several length buckets, compacted selection) and the edge DB
    ('N', lowercase, duplicates, palindromes, sequences shorter than k,
    a one-row bucket): every PrefDB column equal."""
    db = _db(kind)
    mine = K.kmermatcher_device(db, k, 200, 0.2, only_ext, device="cpu")
    assert len(mine.qkey) > len(db)
    assert_prefdb_equal(mine, kmermatcher(db, k, 200, 0.2, only_ext))
    jdb = to_jax_db(db)
    assert_prefdb_equal(mine, J.kmermatcher_device(jdb, k, 200, 0.2,
                                                   only_ext))
    assert_prefdb_equal(mine, jax_kmermatcher(jdb, k, 200, 0.2, only_ext))


@pytest.mark.parametrize("cov_mode", [0, 1, 2, 3, 4, 5])
def test_kmermatcher_device_coverage_modes(cov_mode):
    """cov_mode 0-5 with a coverage threshold that drops pairs, against
    the host kmermatcher and, for modes 0-2, the JAX device kmermatcher
    (which keeps every pair under modes 3-5, unlike the host's
    Util::canBeCovered; the port follows the host)."""
    db = contig_db(74 + cov_mode, 120, 60, 600, 20_000)
    args = (20, 60, 0.2, False, 67, cov_mode, 0.6)
    mine = K.kmermatcher_device(db, *args, device="cpu")
    assert_prefdb_equal(mine, kmermatcher(db, *args))
    assert_prefdb_equal(mine, jax_kmermatcher(to_jax_db(db), *args))
    if cov_mode <= 2:
        assert_prefdb_equal(mine, J.kmermatcher_device(to_jax_db(db),
                                                       *args))
    if cov_mode in (0, 2, 3, 5):    # 1 and 4 keep all: the centre is longest
        assert len(mine.qkey) < len(K.kmermatcher_device(
            db, *args[:6], 0.0, device="cpu").qkey)


def test_kmermatcher_device_packing_budget_raises(monkeypatch):
    """At the JAX package's packing budget the stage raises ValueError
    (the pipeline's one route to the host path)."""
    db = reads_world(75, 100)[0]
    monkeypatch.setattr(K, "B_ID", 6)
    with pytest.raises(ValueError, match="packing budget"):
        K.kmermatcher_device(db, 20, 200, 0.2, False, device="cpu")


@pytest.fixture(scope="module")
def planes():
    """A (B, L) code plane of one length bucket with 'N' codes, lengths
    below and at L, and rows shorter than k."""
    db = chip_smoke.kmer_edge_db(np.random.default_rng(76))
    bl, ids = K.bucketize(db)[0]
    lens = db.lengths[ids].astype(np.int32)
    codes = K.code_plane(torch.from_numpy(db.data),
                         torch.from_numpy(db.offsets[ids]),
                         torch.from_numpy(lens), bl).numpy()
    want = np.full(codes.shape, 4, np.uint8)
    for r, i in enumerate(ids):
        want[r, :lens[r]] = CHAR_TO_CODE[db.seq_bytes(i)]
    assert (codes == want).all()
    return codes, lens


def test_kernel_a_plain_versions_match_jax(planes):
    codes, lens = planes
    tc, tl = torch.from_numpy(codes), torch.from_numpy(lens)
    for k in (20, 22):
        id_hash, key2, ps = K.kmer_windows(tc, tl, k, 67)
        with jax.enable_x64(True):
            jc, jl = jnp.asarray(codes.astype(np.int8)), jnp.asarray(lens)
            j_id = np.asarray(J._identity_hash(jc, jl, 67))
            j_key2, j_ps = (np.asarray(x) for x in
                            J._windows_bucket(jc, jl, k, 67))
        assert (_u64(id_hash) == j_id).all()
        assert (_u64(key2) == j_key2).all()
        assert (ps.numpy().view(np.uint32) == j_ps).all()
        assert (j_key2 == np.uint64(2 ** 64 - 1)).any()    # masked windows


def test_kernel_b_plain_version_matches_jax(planes):
    """The select walk over the same sorted rows; kps small enough that
    subsampling bites on every row."""
    codes, lens = planes
    tc, tl = torch.from_numpy(codes), torch.from_numpy(lens)
    _, key2, ps = K.kmer_windows(tc, tl, 20, 67)
    key2s, ps_s = K.rowsort_bucket(key2, ps)
    with jax.enable_x64(True):
        jk, jp = J._rowsort_bucket(jnp.asarray(_u64(key2)),
                                   jnp.asarray(ps.numpy().view(np.uint32)))
        assert (_u64(key2s) == np.asarray(jk)).all()
        assert (ps_s.numpy().view(np.uint32) == np.asarray(jp)).all()
        for kps, scale in ((200, 0.2), (12, 0.1), (2, 0.0)):
            hits = K.select_walk(key2s, tl, 20, kps, scale)
            j_hits = np.asarray(J._select_bucket(jk, jnp.asarray(lens), 20,
                                                 kps, scale))
            assert (hits.numpy() == j_hits).all()
            assert hits.any()


def test_kernel_c_plain_version_matches_jax():
    """The segmented suffix argmax against the JAX tiled scan (ties in s,
    segments across its tiles), and the OR scan against a sequential
    loop."""
    rng = np.random.default_rng(77)
    M = 1 << 14
    s = rng.integers(1, 30, M)
    f = rng.random(M) < 0.01
    f[1000:5000] = False
    ts, tj = K.seg_suffix_scan(K.SCAN_ARGMAX, torch.from_numpy(s),
                               torch.arange(M), torch.from_numpy(f))
    js, jj = J._seg_suffix_argmax(jnp.asarray(s, jnp.int32),
                                  jnp.arange(M, dtype=jnp.int32),
                                  jnp.asarray(f))
    assert (ts.numpy() == np.asarray(js)).all()
    assert (tj.numpy() == np.asarray(jj)).all()

    v = rng.random(M) < 0.05
    out, = K.seg_suffix_scan(K.SCAN_OR, torch.from_numpy(v),
                             torch.from_numpy(f))
    want = np.zeros(M, bool)
    acc = False
    for i in range(M - 1, -1, -1):
        acc = v[i] or (acc and not f[i])
        want[i] = acc
    assert (out.numpy() == want).all()


def test_xxh64_and_revcomp_match_the_host_helpers():
    """The int64 helpers against kmer/xxh64.py and kmer/packing.py on
    words with the top bit set."""
    rng = np.random.default_rng(78)
    a = rng.integers(0, 2 ** 64, 50_000, dtype=np.uint64)
    a[:1000] |= np.uint64(1) << np.uint64(63)
    t = torch.from_numpy(a.view(np.int64))
    for seed in (67, 0, 2 ** 40 + 3):
        assert (_u64(K.xxh64_u64(t, seed)) == xxh64.xxh64_u64(a, seed)).all()
    for k in (1, 20, 22, 31):
        kv = a >> np.uint64(64 - 2 * k)
        got = K.revcomp(torch.from_numpy(kv.view(np.int64)), k)
        assert (_u64(got) == packing.revcomp_kmer(kv, k)).all()
