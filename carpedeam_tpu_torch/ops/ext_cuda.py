"""Safe-mode consensus window of the read-phase extension scoring on the
card (kernel: csrc/ext.cu).

Port of carpedeam_tpu/ops/ext_pallas.py:64-197 (reference semantics:
src/assembler/ancientReadsResults.cpp:316-366, nuclassembleUtil.cpp
updateSeqIdConsensusReads / calcLikelihoodConsensus; in safe mode the
consensus is the query centred in the 3L buffer, so every consensus
lookup is an affine query-window mapping).  Per record: total, identity
and RY-identity counts over the used columns, and the f32 damage
log-likelihood sum from an (11, 16) table [layer, 4*qbase+tbase].

The f32 sums feed only records that the caller then re-scores in 80-bit
arithmetic on the host when they enter the extension queue
(ops/extension_batch.py), as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from .._build import KERNELS
from .planes import to_device
from .window_cuda import check_record_inputs

CONSENSUS = KERNELS["consensus_likelihood"]


def consensus_likelihood(sym2: torch.Tensor, qrow: torch.Tensor,
                         trow: torch.Tensor, scal: torch.Tensor,
                         wtab: torch.Tensor) -> torch.Tensor:
    """(n, 4) f32 (total, idc, ryc, lik) per record: query plane row
    qrow, target plane row trow, scal (n, 8) int32 = (qpos0, qlen, tlen,
    ir0, ir1, 0, 0, 0), wtab (11, 16) f32."""
    check_record_inputs(sym2, (qrow, trow), scal, 8)
    if wtab.device != sym2.device or wtab.dtype != torch.float32 \
            or tuple(wtab.shape) != (11, 16) or not wtab.is_contiguous():
        raise TypeError("wtab must be a contiguous (11, 16) float32 tensor "
                        "on the planes' device")
    if sym2.device.type == "cpu":
        return consensus_likelihood_reference(sym2, qrow, trow, scal, wtab)
    out = torch.empty((qrow.shape[0], 4), dtype=torch.float32,
                      device=sym2.device)
    CONSENSUS.launch(wtab.data_ptr(), sym2.data_ptr(), sym2.shape[1],
                     qrow.data_ptr(), trow.data_ptr(), scal.data_ptr(),
                     qrow.shape[0], out.data_ptr(),
                     torch.cuda.current_stream(sym2.device).cuda_stream)
    return out


def consensus_likelihood_reference(sym2, qrow, trow, scal, wtab
                                   ) -> torch.Tensor:
    """Plain tensor version of the consensus kernel; the f32 likelihood
    is summed column by column, left to right, like the kernel."""
    L = sym2.shape[1]
    dev = sym2.device
    q = sym2[qrow.to(torch.int64)].to(torch.int64)
    t = sym2[trow.to(torch.int64)].to(torch.int64)
    s = scal.to(torch.int64)
    qpos0, qlen, tlen = s[:, 0:1], s[:, 1:2], s[:, 2:3]
    ir0, ir1 = s[:, 3:4], s[:, 4:5]
    pos = torch.arange(L, device=dev)[None, :]
    q_al = torch.gather(q, 1, (pos + qpos0 % L) % L)
    qp = qpos0 + pos
    use = (t != ord("N")) & (pos < tlen) & (qp >= 0) & (qp < qlen) \
        & (pos >= ir0) & (pos < ir1) & (q_al != ord("N"))
    total = use.sum(dim=1)
    idc = ((q_al == t) & use).sum(dim=1)
    is_ct = lambda x: (x == ord("C")) | (x == ord("T"))  # noqa: E731
    ryc = ((is_ct(q_al) == is_ct(t)) & use).sum(dim=1)

    def code(x):
        c = torch.zeros_like(x)
        c = torch.where(x == ord("C"), 1, c)
        c = torch.where(x == ord("G"), 2, c)
        return torch.where(x == ord("T"), 3, c)

    layer = torch.where(pos < 5, pos, 5).expand(q.shape[0], L)
    layer = torch.where(pos >= tlen - 5, 6 + pos - (tlen - 5), layer)
    layer = torch.clamp(layer, 0, 10)   # only used columns are read
    val = wtab.reshape(-1)[layer * 16 + code(q_al) * 4 + code(t)]
    val = torch.where(use, val, torch.zeros((), dtype=torch.float32,
                                            device=dev))
    lik = torch.zeros(q.shape[0], dtype=torch.float32, device=dev)
    for p in range(L):
        lik = lik + val[:, p]
    return torch.stack([total.to(torch.float32), idc.to(torch.float32),
                        ryc.to(torch.float32), lik], dim=1)


def consensus_likelihood_cuda(planes, n_seqs: int, qid, tid, qpos0, qlen,
                              tlen, ir0, ir1, logm):
    """Per-record (total, idc, ryc, lik) over the safe-mode consensus
    window; forward strand only (the read phase drops reverse hits before
    this pass).  Returns (int64, int64, int64, float64) host arrays."""
    sym2 = planes["sym"]
    dev = sym2.device
    n = len(qid)
    scal = np.zeros((n, 8), np.int32)
    scal[:, 0] = qpos0
    scal[:, 1] = qlen
    scal[:, 2] = tlen
    scal[:, 3] = ir0
    scal[:, 4] = ir1
    wtab = np.asarray(logm, dtype=np.float32).reshape(11, 16)
    out = consensus_likelihood(
        sym2, to_device(np.asarray(qid, np.int32), dev),
        to_device(np.asarray(tid, np.int32), dev), to_device(scal, dev),
        to_device(wtab, dev)).cpu().numpy()
    return (out[:, 0].astype(np.int64), out[:, 1].astype(np.int64),
            out[:, 2].astype(np.int64), out[:, 3].astype(np.float64))
