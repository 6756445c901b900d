"""The port's fused correction (carpedeam_tpu_torch.ops.correction_cuda,
plain PyTorch version on the CPU) against the JAX package's Pallas
correction (interpret mode) and the host oracle: identical corrected
bytes, identical packed kernel output, identical derived planes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import carpedeam_tpu.ops.correction_pallas as CP
from carpedeam_tpu.stages.rescorediagonal import \
    rescorediagonal as jax_rescorediagonal
from carpedeam_tpu_torch.aligndb import AlnDB
from carpedeam_tpu_torch.damage import DamageModel
from carpedeam_tpu_torch.kmer.matcher import kmermatcher
from carpedeam_tpu_torch.ops import correction_cuda as C
from carpedeam_tpu_torch.ops.planes import device_planes
from carpedeam_tpu_torch.stages.correction import (correction,
                                                   prepare_correction_inputs)
from carpedeam_tpu_torch.stages.rescorediagonal import rescorediagonal
from carpedeam_tpu_torch.utils import coverage_reset, coverage_summary
from carpedeam_tpu_torch.workload import profile_rates
from torch_port_util import (contig_db, damage_pair, reads_world, same_seqs,
                             to_jax_db)


@pytest.fixture(scope="module")
def world():
    db, jdb, jdm, tdm = reads_world(31, 1500)
    pref = kmermatcher(db, 20, 200, 0.2, False)
    aln = rescorediagonal(db, pref, 0.9)
    return db, jdb, aln, jdm, tdm


def _jax_aln(jdb):
    from carpedeam_tpu.kmer.matcher import kmermatcher as jk
    return jax_rescorediagonal(jdb, jk(jdb, 20, 200, 0.2, False), 0.9)


@pytest.fixture
def small_blocks(monkeypatch):
    monkeypatch.setattr(CP, "NB_BUCKET", 4)   # interpret mode is slow


def test_correction_matches_pallas_and_oracle(world, small_blocks):
    db, jdb, aln, jdm, tdm = world
    mine = C.correction_cuda(db, aln, tdm, 0.99, 0.9, device="cpu")
    ref = CP.correction_pallas(jdb, _jax_aln(jdb), jdm, 0.99, 0.9)
    ora = correction(db, aln, tdm, 0.99, 0.9)
    changed = sum(bytes(ora.seq_bytes(i)) != bytes(db.seq_bytes(i))
                  for i in range(len(db)))
    assert changed > 0, "fixture must exercise real corrections"
    assert same_seqs(mine, ref)
    assert same_seqs(mine, ora)


def test_kernel_output_matches_pallas_kernel(world):
    """Raw packed 2-bit output of the correction kernel's plain version
    equals the Pallas kernel's on the same blocks."""
    db, _, aln, _, tdm = world
    planes, lengths = device_planes(db, max_len=128, device="cpu")
    n = len(db)
    rec = prepare_correction_inputs(db, aln, n, 0.99, 0.9)
    g, rt = C._tiles_for(128)
    blocks = C.build_correction_blocks(rec, lengths, n, g=g, rec_tile=rt)
    nb, sel, use = blocks["nb"], blocks["sel"], blocks["use"]
    rscal = np.zeros((nb * rt, 8), np.int32)
    for j, k in enumerate(("rec_qstart", "rec_tstart", "rec_alen")):
        rscal[:, j] = rec[k][sel]
    rscal[:, 3] = db.lengths[rec["rec_t_row"][sel] % n]
    rscal[:, 4] = rec["rec_ry_smin"][sel]
    rscal[:, 5] = use
    rscal[:, 6] = blocks["qslot"][:, 0, :].reshape(-1)
    rscal[:, 7] = rec["rec_is_rev"][sel] & use
    qscal = np.zeros((nb * g, 8), np.int32)
    qscal[:, 0] = lengths[blocks["slot_qid"]]
    qscal[:, 1] = db.ext[blocks["slot_qid"]] & blocks["slot_valid"]
    rows = rec["rec_t_row"][sel].astype(np.int32)
    slot_qid = blocks["slot_qid"].astype(np.int32)
    wtab = C.correction_wtab(tdm)
    mine = C.correction_kernel(
        planes["sym"], torch.from_numpy(rows), torch.from_numpy(rscal),
        torch.from_numpy(slot_qid), torch.from_numpy(qscal),
        torch.from_numpy(wtab), g, rt)
    ref = CP._correction_pallas_device(
        jnp.asarray(planes["sym"].numpy()), jnp.asarray(rows),
        jnp.asarray(rscal), jnp.asarray(slot_qid), jnp.asarray(qscal),
        jnp.asarray(wtab), nb=nb, max_len=128, interpret=True, g=g,
        rec_tile=rt)
    assert np.array_equal(mine.numpy(), np.asarray(ref).view(np.uint8))


def test_derived_planes_match_fresh_pack(world):
    db, _, aln, _, tdm = world
    planes, lengths = device_planes(db, max_len=128, device="cpu")
    fin, shared = C.correction_cuda(db, aln, tdm, 0.99, 0.9, planes=planes,
                                    lengths=lengths, return_planes=True,
                                    defer=True)
    out = fin()
    assert shared is not None, "shared planes must derive on this input"
    fresh, fresh_len = device_planes(out, max_len=128, device="cpu")
    assert np.array_equal(shared["lengths"], fresh_len)
    for k in ("sym", "code", "len"):
        assert torch.equal(shared["planes"][k], fresh[k]), k


def test_heavy_queries_take_the_host_oracle(world, monkeypatch):
    db, _, aln, _, tdm = world
    monkeypatch.setattr(C, "_tiles_for", lambda L: (8, 8))
    coverage_reset()
    mine = C.correction_cuda(db, aln, tdm, 0.99, 0.9, device="cpu")
    cov = coverage_summary()["correction"]
    coverage_reset()
    assert cov["host"] > 0 and cov["device"] > 0
    assert same_seqs(mine, correction(db, aln, tdm, 0.99, 0.9))


def test_empty_alignment_passes_through(world):
    db, _, _, _, tdm = world
    empty = AlnDB.from_arrays(
        qkey=np.zeros(0, np.uint32), qkeys=np.zeros(0, np.uint32),
        starts=np.zeros(1, np.int64),
        **{name: np.zeros(0) for name in
           ("tkey", "score", "seq_id", "eval", "qstart", "qend",
            "qlen", "dbstart", "dbend", "dblen")})
    out = C.correction_cuda(db, empty, tdm, 0.99, 0.9, device="cpu")
    assert same_seqs(out, db)


def test_chunked_long_contig_levels_match_pallas(small_blocks, monkeypatch):
    """Contigs of 2500-6000 bp run in the 4096/8192 levels (the TPU's
    chunked kernel variant) and match the Pallas path and the oracle."""
    from carpedeam_tpu.kmer.matcher import kmermatcher as jk
    db = contig_db(33, 24, 2500, 6000, 9000, sub_rate=0.01)
    jdb = to_jax_db(db)
    jdm, tdm = damage_pair(*profile_rates())
    aln = rescorediagonal(db, kmermatcher(db, 22, 200, 0.2, False), 0.9)
    widths = []
    real = C._run_correction_level
    monkeypatch.setattr(C, "_run_correction_level", lambda pl, *a, **k: (
        widths.append(pl["sym"].shape[1]) or real(pl, *a, **k)))
    monkeypatch.setattr(CP, "NB_BUCKET", 1)
    mine = C.correction_cuda(db, aln, tdm, 0.99, 0.9, device="cpu")
    ref = CP.correction_pallas(
        jdb, jax_rescorediagonal(jdb, jk(jdb, 22, 200, 0.2, False), 0.9),
        jdm, 0.99, 0.9)
    ora = correction(db, aln, tdm, 0.99, 0.9)
    assert any(w > 2048 for w in widths), widths
    assert any(bytes(ora.seq_bytes(i)) != bytes(db.seq_bytes(i))
               for i in range(len(db)))
    assert same_seqs(mine, ref)
    assert same_seqs(mine, ora)


@pytest.mark.parametrize("L", [2048, 8192])
def test_edge_blocks_at_the_top_levels_match_pallas_kernel(L):
    """chip_smoke's correction edge blocks (slots with 0, 1, 2 and more
    kept records, records crossing 128-position tiles, both target ends)
    at the ladder's upper levels, with the (G, R) that correction_cuda
    picks there: the plain version equals the Pallas kernel."""
    import chip_smoke
    _, tdm = damage_pair(*profile_rates())
    g, rt = C._tiles_for(L)
    args = chip_smoke._correction_edges(np.random.default_rng(L), L, g, rt,
                                        2, C.correction_wtab(tdm), False,
                                        True, "cpu")
    sym2, rows, rscal, slot_qid, qscal, wtab, g, rt = args
    mine = C.correction_kernel(*args)
    ref = CP._correction_pallas_device(
        *(jnp.asarray(t.numpy()) for t in (sym2, rows, rscal, slot_qid,
                                           qscal, wtab)),
        nb=2, max_len=L, interpret=True, g=g, rec_tile=rt)
    assert (rscal[:, 5] != 0).sum() > 10
    assert np.array_equal(mine.numpy(), np.asarray(ref).view(np.uint8))


def test_kernel_rejects_what_it_does_not_take():
    sym = torch.zeros((8, 128), dtype=torch.uint8)
    i32 = lambda *s: torch.zeros(s, dtype=torch.int32)  # noqa: E731
    wtab = torch.zeros((48, 16), dtype=torch.float32)
    with pytest.raises(ValueError):
        C.correction_kernel(sym, i32(7), i32(8, 8), i32(4), i32(4, 8),
                            wtab, 4, 8)     # 7 record rows for 8 slots
    with pytest.raises(TypeError):
        C.correction_kernel(sym, i32(8), i32(8, 8), i32(4), i32(4, 8),
                            wtab.double(), 4, 8)
    with pytest.raises(ValueError):
        C.correction_kernel(sym, i32(1024), i32(1024, 8), i32(4),
                            i32(4, 8), wtab, 4, 1024)


@pytest.mark.parametrize("rate", [0.0, 1.0])
def test_correction_wtab_is_finite(rate):
    """The kernel's sparse class sums are exact only for finite weights
    (0 * inf is NaN): the table is finite at both ends of the rate range,
    since every probability is clipped to 1e-3 before its log."""
    rows = np.full((5, 12), rate)
    wtab = C.correction_wtab(DamageModel.from_rates(rows, rows))
    assert wtab.shape == (48, 16) and wtab.dtype == np.float32
    assert np.isfinite(wtab).all()


def _sparse_blocks(seed: int, L: int, g: int, rt: int, nb: int):
    """Blocks in which most slots hold 0 or 1 record, so most (slot,
    position) cells have coverage below 2: (kernel arguments, share of the
    block cells with coverage below 2)."""
    rng = np.random.default_rng(seed)
    n = 24
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    sym = bases[rng.integers(0, 4, (2 * n, L))]
    rscal = np.zeros((nb * rt, 8), np.int32)
    rscal[:, 6] = g
    rows = rng.integers(0, 2 * n, nb * rt).astype(np.int32)
    qscal = np.zeros((nb * g, 8), np.int32)
    qscal[:, 0] = rng.integers(L // 2, L + 1, nb * g)
    qscal[:, 1] = rng.random(nb * g) < 0.2
    cover = np.zeros((nb * g, L), np.int32)
    for b in range(nb):
        i = b * rt
        for s in range(g):
            for _ in range(int(rng.choice(3, p=[0.45, 0.4, 0.15]))):
                if i == (b + 1) * rt:
                    break
                qs = int(rng.integers(0, L - 8))
                alen = int(rng.integers(8, L - qs + 1))
                ts = int(rng.integers(0, 6))
                rscal[i] = (qs, ts, alen, ts + alen + int(rng.integers(0, 6)),
                            0, 1, s, int(rng.random() < 0.5))
                cover[b * g + s, qs:qs + alen] += 1
                i += 1
    slot_qid = rng.integers(0, 2 * n, nb * g).astype(np.int32)
    return (sym, rows, rscal, slot_qid, qscal), float((cover < 2).mean())


@pytest.mark.parametrize("seed", [41, 42])
def test_plain_matches_pallas_where_most_cells_are_uncovered(seed):
    """Cells with coverage below 2 keep their base without a sum: the plain
    version and the Pallas kernel (interpret mode) agree on blocks made
    mostly of such cells."""
    _, tdm = damage_pair(*profile_rates())
    L, g, rt, nb = 128, 32, 64, 2
    (sym, rows, rscal, slot_qid, qscal), low = _sparse_blocks(seed, L, g,
                                                               rt, nb)
    assert low > 0.5
    wtab = C.correction_wtab(tdm)
    mine = C.correction_kernel(*(torch.from_numpy(a) for a in
                                 (sym, rows, rscal, slot_qid, qscal, wtab)),
                               g, rt)
    ref = CP._correction_pallas_device(
        *(jnp.asarray(a) for a in (sym, rows, rscal, slot_qid, qscal, wtab)),
        nb=nb, max_len=L, interpret=True, g=g, rec_tile=rt)
    assert np.array_equal(mine.numpy(), np.asarray(ref).view(np.uint8))
