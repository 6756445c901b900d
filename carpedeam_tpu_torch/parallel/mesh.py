"""Device-sharded rescore and correction (`--use-device mesh`).

Port of carpedeam_tpu/parallel/mesh.py.  The JAX package runs its
`--use-device 1` tensor programs under `shard_map` over a device mesh;
here the mesh is a list of torch devices and the shard_map is an
explicit loop over it:

* pairs (rescore), alignment records and positions (correction) split
  into d contiguous shards, one per mesh device (the last ones may be
  one shorter).  The JAX package pads them to bucket sizes to reuse its
  compilations; padding changes no output, so the port has none;
* the sequence planes, packed as wide as the longest sequence, are
  replicated on every device of the mesh;
* each shard runs the `--use-device 1` programs (ops/rescore_device.py,
  ops/correction_device.py) on its device;
* the correction's int32 count vectors, the `psum` of the JAX program,
  are copied to the first device and added there: integer addition, so
  the order of the shards cannot change a count;
* the per-position argmax runs on each device's slice of the positions,
  and the slices are concatenated in shard order.

A mesh may name one device more than once; the CPU tests and the
one-card smoke run shard over [device] * k that way.  The stages equal
the single-device `--use-device 1` stages and the host oracles.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.correction_device import (correction_argmax, correction_scatter,
                                     correction_tables, corrected_db,
                                     position_inputs)
from ..ops.planes import device_planes, to_device
from ..ops.rescore_device import rescore_pairs_device
from ..utils import bucket_len, coverage_add, resolve_device


def make_mesh(devices: list | None = None) -> tuple[torch.device, ...]:
    """The mesh's devices, in shard order.  None means every visible
    card, cuda:0 .. cuda:{device_count-1} (raises without one); a list
    may name the same device more than once."""
    if devices is None:
        resolve_device("cuda")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return tuple(resolve_device(d) for d in devices)


def _shards(n: int, d: int) -> list[slice]:
    """d contiguous slices covering range(n), as np.array_split cuts."""
    q, r = divmod(n, d)
    edges = [i * q + min(i, r) for i in range(d + 1)]
    return [slice(a, b) for a, b in zip(edges[:-1], edges[1:])]


def _replicated_planes(seqdb, mesh) -> dict:
    """device -> (planes, device lengths): full-width planes packed once
    on the mesh's first device and copied to each other device."""
    planes, lengths = device_planes(seqdb, max_len=bucket_len(
        int(seqdb.lengths.max()) if len(seqdb) else 1), device=mesh[0])
    out = {}
    for dev in mesh:
        if dev not in out:
            out[dev] = ({k: v.to(dev) for k, v in planes.items()},
                        to_device(lengths, dev))
    return out


def rescorediagonal_sharded(mesh):
    """A drop-in stage fn(seqdb, pref, seq_id_thr, eval_thr, aln_len_thr)
    scoring the pairs data-parallel over the mesh."""
    d = len(mesh)

    def stage(seqdb, pref, seq_id_thr, eval_thr=0.001, aln_len_thr=0):
        from ..stages.rescorediagonal import assemble_alndb

        rep = _replicated_planes(seqdb, mesh)
        n = len(pref.qkey)
        rec = {"qidx": seqdb.lookup_keys(pref.qkey),
               "tidx": seqdb.lookup_keys(pref.tkey),
               "diag": pref.diag.astype(np.int64),
               "is_rev": pref.score < 0}
        parts = []
        for dev, sl in zip(mesh, _shards(n, d)):
            planes, lens = rep[dev]
            out = rescore_pairs_device(
                planes["code"], planes["sym"], lens,
                *(to_device(rec[k][sl], dev)
                  for k in ("qidx", "tidx", "diag", "is_rev")))
            parts.append({k: v.cpu().numpy() for k, v in out.items()})
        raw = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        coverage_add("rescorediagonal", n, 0)
        return assemble_alndb(seqdb, pref, raw, seq_id_thr, eval_thr,
                              aln_len_thr)

    return stage


def correction_sharded(mesh):
    """A drop-in stage fn(seqdb, aln, damage, corr_reads_ry_seq_id,
    seq_id_thr) with records and positions sharded over the mesh."""
    from ..stages.correction import prepare_correction_inputs

    d = len(mesh)

    def stage(seqdb, aln, damage, corr_reads_ry_seq_id, seq_id_thr):
        rep = _replicated_planes(seqdb, mesh)
        n = len(seqdb)
        total_len = int(seqdb.lengths.sum())
        rec = prepare_correction_inputs(seqdb, aln, n, corr_reads_ry_seq_id,
                                        seq_id_thr)
        counts = rev_counts = None
        for dev, sl in zip(mesh, _shards(len(rec["rec_q"]), d)):
            planes, lens = rep[dev]
            c, r = correction_scatter(
                planes["sym"], lens,
                *(to_device(rec[k][sl], dev) for k in (
                    "rec_q", "rec_t_row", "rec_qstart", "rec_tstart",
                    "rec_alen", "rec_is_rev", "rec_keep_pre", "rec_ry_smin",
                    "rec_goffset")),
                total_len)
            c, r = c.to(mesh[0]), r.to(mesh[0])
            counts = c if counts is None else counts + c
            rev_counts = r if rev_counts is None else rev_counts + r

        pos = dict(zip(("obs", "own_layer", "was_ext_pos"),
                       position_inputs(seqdb)))
        tables = correction_tables(damage)
        counts = counts.view(total_len, 44)
        rev_counts = rev_counts.view(total_len, 44)
        corrected, tot = [], []
        for dev, sl in zip(mesh, _shards(total_len, d)):
            cb, tb = correction_argmax(
                counts[sl].to(dev), rev_counts[sl].to(dev),
                *(to_device(pos[k][sl], dev)
                  for k in ("obs", "own_layer", "was_ext_pos")),
                *(to_device(t, dev) for t in tables))
            corrected.append(cb.cpu().numpy())
            tot.append(tb.cpu().numpy())
        coverage_add("correction", n, 0)
        return corrected_db(seqdb, np.concatenate(corrected),
                            np.concatenate(tot))

    return stage


def kmer_hash_ranges(n_shards: int) -> list[tuple[int, int]]:
    """Disjoint 16-bit hash ranges per shard (the reference's MPI split
    scheme, kmermatcher.cpp:636-664; uniform here, where the reference
    sizes splits from the measured hash histogram)."""
    edges = np.linspace(0, 65536, n_shards + 1).astype(np.int64)
    return [(int(edges[i]), int(edges[i + 1] - 1)) for i in range(n_shards)]
