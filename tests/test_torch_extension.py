"""The port's read-phase extension scoring kernels (window identity and
consensus likelihood, plain PyTorch versions on the CPU) against the JAX
package's Pallas kernels (interpret mode), on the main path's records and
on the adversarial records of chip_smoke.py's `edges` phase, and the
port's batched scoring with device planes against its host path."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carpedeam_tpu.ops.ext_pallas import consensus_likelihood_pallas
from carpedeam_tpu.ops.rescore_tpu import _assemble_planes
from carpedeam_tpu.ops.rescore_tpu import pack_sequences as jax_pack
from carpedeam_tpu.ops.window_pallas import window_identity_pallas
from carpedeam_tpu_torch.convert import consensus_logm
from carpedeam_tpu_torch.kmer.matcher import kmermatcher
from carpedeam_tpu_torch.ops import ext_cuda, window_cuda
from carpedeam_tpu_torch.ops.extension_batch import (_prologue_arrays,
                                                     batch_initial_scoring)
from carpedeam_tpu_torch.ops.planes import device_planes
from carpedeam_tpu_torch.stages.correction import correction
from carpedeam_tpu_torch.stages.rescorediagonal import rescorediagonal
from torch_port_util import reads_world, to_jax_db

import chip_smoke

# The consensus kernel's f32 log-likelihood sum runs column by column in
# the port and as a lane reduction in the Pallas kernel; the two orders
# may differ in the last bits.  1e-4 absolute is ~10 ulp of a sum of
# ~100 terms of magnitude <= 10.  (The extension re-scores every queue
# entrant in 80-bit arithmetic on the host, so no decision reads it.)
LIK_ATOL = 1e-4


@pytest.fixture(scope="module")
def world():
    db, jdb, jdm, tdm = reads_world(41, 1500)
    aln = rescorediagonal(db, kmermatcher(db, 20, 200, 0.2, False), 0.9)
    corr = correction(db, aln, tdm, 0.99, 0.9)
    planes, lengths = device_planes(corr, max_len=128, device="cpu")
    fwd, jlen = jax_pack(to_jax_db(corr), max_len=128, fwd_only=True)
    jplanes = _assemble_planes(jnp.asarray(fwd["sym"]), jnp.asarray(jlen))
    return corr, aln, tdm, planes, lengths, jplanes


def test_window_identity_matches_pallas(world):
    corr, aln, _, planes, _, jplanes = world
    pro = _prologue_arrays(corr, aln)
    rt = np.nonzero(pro["terminal"] & pro["not_identity"])[0]
    assert len(rt) > 500
    args = (len(corr), pro["qid"][rt], pro["tid"][rt],
            np.zeros(len(rt), bool), pro["qs"][rt], pro["ts"][rt],
            (pro["qe"] - pro["qs"] + 1)[rt])
    idc, ryc = window_cuda.window_identity_cuda(planes, *args)
    jidc, jryc = window_identity_pallas(jplanes, *args, interpret=True)
    assert np.array_equal(idc, jidc) and np.array_equal(ryc, jryc)


def test_window_identity_reverse_rows_and_edges():
    """Reverse-strand target rows and windows running off the row edge
    follow the TPU kernel's rotation semantics."""
    db, _, _, _ = reads_world(42, 200)
    planes, lengths = device_planes(db, max_len=128, device="cpu")
    rng = np.random.default_rng(0)
    n = 400
    qid = rng.integers(0, len(db), n)
    tid = rng.integers(0, len(db), n)
    rev = rng.random(n) < 0.5
    qs = rng.integers(0, 100, n)
    ts = rng.integers(0, 100, n)
    win = rng.integers(1, 60, n)
    idc, ryc = window_cuda.window_identity_cuda(planes, len(db), qid, tid,
                                                rev, qs, ts, win)
    jplanes = {k: jnp.asarray(v.numpy()) for k, v in planes.items()}
    jidc, jryc = window_identity_pallas(jplanes, len(db), qid, tid, rev,
                                        qs, ts, win, interpret=True)
    assert np.array_equal(idc, jidc) and np.array_equal(ryc, jryc)


@pytest.mark.parametrize("L", [128, 384, 512])
def test_window_identity_edge_records_match_pallas(L):
    """The `edges` phase's window records (windows that wrap past the
    target row's end, empty windows, windows cut at the row end, a plane
    width that is not a power of two) count the same in the port's plain
    version and the Pallas kernel."""
    w = chip_smoke.window_edge_records(np.random.default_rng(L), L, 400)
    assert np.bincount(w["kind"], minlength=5).min() > 0
    n_rows = w["sym2"].shape[0] // 2
    scal = w["scal"]
    args = (n_rows, w["qrow"], w["trow"] % n_rows, w["trow"] >= n_rows,
            scal[:, 0], scal[:, 1], scal[:, 2])
    idc, ryc = window_cuda.window_identity_cuda(
        {"sym": torch.from_numpy(w["sym2"])}, *args)
    jidc, jryc = window_identity_pallas({"sym": jnp.asarray(w["sym2"])},
                                        *args, interpret=True)
    assert np.array_equal(idc, jidc) and np.array_equal(ryc, jryc)
    assert (idc[w["kind"] == 2] == 0).all() and idc.sum() > 0


@pytest.mark.parametrize("L", [128, 384, 512])
def test_consensus_likelihood_edge_records_match_pallas(L):
    """The `edges` phase's consensus records (negative qpos0, 'N' in both
    rows, targets shorter than 10, ir0/ir1 inside the row, records
    without a used column, queries that wrap past the row end) give the
    same counts in the port's plain version and the Pallas kernel, and
    likelihoods within LIK_ATOL.  The table holds distinct multiples of
    2**-10 in (-8, 0], so every partial sum of up to 512 columns is exact
    in f32 and the two sums agree bit for bit whatever their order: a
    wrong layer or base code shows as a difference."""
    rng = np.random.default_rng(L)
    c = chip_smoke.consensus_edge_records(rng, L, 400)
    logm = (-rng.permutation(8192)[:176] / 1024).astype(np.float32)
    s = c["scal"]
    args = (c["sym2"].shape[0] // 2, c["qrow"], c["trow"], s[:, 0], s[:, 1],
            s[:, 2], s[:, 3], s[:, 4], logm.reshape(11, 16))
    mine = ext_cuda.consensus_likelihood_cuda(
        {"sym": torch.from_numpy(c["sym2"])}, *args)
    ref = consensus_likelihood_pallas({"sym": jnp.asarray(c["sym2"])},
                                      *args, interpret=True)
    for a, b in zip(mine[:3], ref[:3]):
        assert np.array_equal(a, b)
    np.testing.assert_allclose(mine[3], ref[3], rtol=0, atol=LIK_ATOL)
    assert np.array_equal(mine[3], ref[3])
    used = mine[0] > 0
    for kind in (1, 2, 3, 5):
        assert (used & (c["kind"] == kind)).any(), kind
    assert not used[c["kind"] == 4].any()
    assert (used & (s[:, 2] < 10)).any()


def test_consensus_likelihood_matches_pallas(world):
    corr, aln, tdm, planes, _, jplanes = world
    pro = _prologue_arrays(corr, aln)
    cc = np.nonzero(pro["terminal"] & pro["not_identity"])[0]
    qs, qe, ts, te = (pro[k][cc] for k in ("qs", "qe", "ts", "te"))
    qlen, tlen, alen = pro["qlen"][cc], pro["tlen"][cc], pro["alen"][cc]
    left = (qs == 0) & (te == tlen - 1)
    offs = tlen - alen
    qpos0 = np.where(left, -offs, qlen - alen)
    base = np.where(left, qlen - offs, 2 * qlen - alen)
    logm = consensus_logm(tdm)
    args = (len(corr), pro["qid"][cc], pro["tid"][cc], qpos0, qlen, tlen,
            -base, 3 * qlen - base, logm)
    mine = ext_cuda.consensus_likelihood_cuda(planes, *args)
    ref = consensus_likelihood_pallas(jplanes, *args, interpret=True)
    for a, b in zip(mine[:3], ref[:3]):
        assert np.array_equal(a, b)
    assert (mine[0] > 0).sum() > 500
    np.testing.assert_allclose(mine[3], ref[3], rtol=0, atol=LIK_ATOL)


def test_consensus_plain_sum_is_column_ordered(world):
    """The plain version's likelihood equals a float32 left-to-right sum
    of the used columns' table values (the kernel's order)."""
    corr, aln, tdm, planes, _, _ = world
    sym2 = planes["sym"]
    rng = np.random.default_rng(1)
    n = 64
    scal = np.zeros((n, 8), np.int32)
    scal[:, 0] = rng.integers(-60, 60, n)          # qpos0
    scal[:, 1] = corr.lengths[:n]                   # qlen
    scal[:, 2] = corr.lengths[n:2 * n]              # tlen
    scal[:, 3] = rng.integers(-20, 20, n)           # ir0
    scal[:, 4] = scal[:, 3] + rng.integers(20, 200, n)
    wtab = torch.from_numpy(consensus_logm(tdm))
    q = torch.arange(n, dtype=torch.int32)
    t = torch.arange(n, 2 * n, dtype=torch.int32)
    out = ext_cuda.consensus_likelihood(sym2, q, t, torch.from_numpy(scal),
                                        wtab)
    codes = {ord("C"): 1, ord("G"): 2, ord("T"): 3}
    w = wtab.numpy().reshape(-1)
    for r in range(n):
        qrow, trow = sym2[r].numpy(), sym2[n + r].numpy()
        qpos0, qlen, tlen, ir0, ir1 = (int(v) for v in scal[r, :5])
        acc = np.float32(0.0)
        for p in range(min(tlen, 128)):
            a, b = int(qrow[(p + qpos0) % 128]), int(trow[p])
            if a == ord("N") or b == ord("N") or not (0 <= qpos0 + p < qlen) \
                    or not (ir0 <= p < ir1):
                continue
            lay = 6 + p - (tlen - 5) if p >= tlen - 5 else min(p, 5)
            acc = np.float32(acc + w[lay * 16 + codes.get(a, 0) * 4
                                     + codes.get(b, 0)])
        assert out[r, 3].item() == acc, r


def test_batch_initial_scoring_device_planes_match_host(world):
    """queue_ok, s_ratio and s_len_norm with device planes equal the host
    (native) path exactly."""
    corr, aln, tdm, planes, lengths, _ = world
    args = (corr, aln, tdm, 0.9, 0.99, 0.5, 0.85, 0.0625)
    dev = batch_initial_scoring(*args, planes=planes, lengths=lengths)
    host = batch_initial_scoring(*args)
    assert dev["queue_ok"].sum() > 50
    for k in ("cand", "queue_ok", "seq_id", "ry_seq_id", "max_left",
              "max_right"):
        assert np.array_equal(dev[k], host[k]), k
    q = dev["queue_ok"]
    for k in ("s_ratio", "s_len_norm"):
        assert np.array_equal(dev[k][q], host[k][q]), k


def test_wrappers_reject_what_the_kernels_do_not_take():
    sym = torch.zeros((4, 128), dtype=torch.uint8)
    i32 = lambda *s: torch.zeros(s, dtype=torch.int32)  # noqa: E731
    with pytest.raises(ValueError):
        window_cuda.window_identity(sym, i32(3), i32(3), i32(3, 8))
    with pytest.raises(TypeError):
        window_cuda.window_identity(sym, i32(3).long(), i32(3), i32(3, 4))
    with pytest.raises(TypeError):
        ext_cuda.consensus_likelihood(sym, i32(3), i32(3), i32(3, 8),
                                      torch.zeros((11, 16),
                                                  dtype=torch.float64))
