"""The port's read-phase extension scoring kernels (window identity and
consensus likelihood, plain PyTorch versions on the CPU) against the JAX
package's Pallas kernels (interpret mode), and the port's batched
scoring with device planes against its host path."""
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
