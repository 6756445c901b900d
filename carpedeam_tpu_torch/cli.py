"""Command-line interface of the port: the JAX package's commands (the
reference binary's `ancient_assemble` and `nuclassemble`, and its
stage-level subcommands on saved DBs), on the card.

    python -m carpedeam_tpu_torch.cli ancient_assemble reads.fq out.fasta \
        tmpDir --ancient-damage prefix [flags] [--device cuda|cpu]
    python -m carpedeam_tpu_torch.cli ancient_assemble R1.fq R2.fq \
        out.fasta tmpDir ...    (paired-end: FLASH-merged, mergereads)
    python -m carpedeam_tpu_torch.cli ancient_assemble ... --world 2

Stage subcommands, one stage of the workflow on saved DBs (the reference's
hidden subcommand surface, src/carpedeam.cpp:25-72; carpedeam_tpu/cli.py:
58-99):

    createdb IN_FASTX OUT_DB [--shuffle 0|1]
    mergereads R1.fq R2.fq [...] OUT_DB
    kmermatcher SEQ_DB OUT_PREF_DB [flags] [--device cuda|cpu]
    rescorediagonal SEQ_DB PREF_DB OUT_ALN_DB [flags] [--device cuda|cpu]
    ancient_correction SEQ_DB ALN_DB OUT_SEQ_DB [flags] [--device ...]
    ancient_read_assemble SEQ_DB ALN_DB OUT_SEQ_DB [flags] [--device ...]
    ancient_contig_merge SEQ_DB ALN_DB OUT_SEQ_DB [flags]
    guidedassembleresult NUCL_DB AA_DB ALN_DB OUT_NUCL_DB OUT_AA_DB [flags]
    createhdb SEQ_DB OUT_DB [--cycle-keys K1,K2,...]
    convert2fasta DB_PREFIX OUT_FASTA
    cyclecheck IN_FASTA OUT_FASTA [--chop-cycle 0|1] [--max-seq-len N]

rescorediagonal, ancient_correction and ancient_read_assemble route
`--use-device` as the pipeline does (pipeline._pick_stage_impls): `auto`
and `pallas` run the CUDA kernels (rescore; correction gate and kernel;
window identity and consensus likelihood) on `--device` over the DB's
shared planes, `0` the host oracles without a card, `1` the tensor
programs and `mesh` the sharded stages.  kmermatcher runs on the host
unless CARPEDEAM_KMER_DEVICE=1 (pipeline._pick_kmermatcher).  The other
subcommands are host code.  Every output equals the JAX package's CLI's.

Flag names and defaults follow src/carpedeam.cpp's command table and
LocalParameters (params.py).  `--world N` spawns and supervises N ranks
of the same command; a process started with CARPEDEAM_RANK and
CARPEDEAM_WORLD (and optionally CARPEDEAM_COORD=host:port, the
torch.distributed rendezvous) runs as one rank of a group sharing
TMP_DIR (parallel/driver.py).  Under `--device cuda` rank r runs on
cuda:(r % device count).  CARPEDEAM_PROFILE_DIR=<dir> writes a
torch.profiler trace of the run (Chrome trace format) into
<dir>/trace.json and the kernels' launch counts into
<dir>/launches.json.  A bad parameter and a missing input exit 1 with a
one-line message, as the JAX package's CLI does.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

from .damage import DamageModel
from .io.seqdb import SeqDB
from .params import (ParamError, add_flags, apply_nuclassemble_defaults,
                     params_from_args)


@contextlib.contextmanager
def _profiler(prof_dir: str | None, device: str):
    if not prof_dir:
        yield
        return
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    from . import _build
    with torch.profiler.profile(activities=acts) as prof:
        yield
    os.makedirs(prof_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(prof_dir, "trace.json"))
    with open(os.path.join(prof_dir, "launches.json"), "w") as fh:
        json.dump(_build.launch_counts(), fh)


def _load_reads(paths: list[str], db_mode: bool = False) -> SeqDB:
    """One reads file -> SeqDB (a saved DB under --db-mode); two or more
    (R1a R2a R1b R2b ...) -> the FLASH-merged pairs (mergereads), as
    carpedeam_tpu/cli.py:25-32."""
    if db_mode:
        return SeqDB.load(paths[0])
    if len(paths) == 1:
        return SeqDB.from_fastx(paths[0])
    from .stages.mergereads import mergereads
    return mergereads(paths)


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    parser = argparse.ArgumentParser(prog="carpedeam-tpu-torch")
    sub = parser.add_subparsers(dest="command", required=True)
    for name in ("ancient_assemble", "nuclassemble"):
        sp = sub.add_parser(name)
        sp.add_argument("files", nargs="+",
                        help="READS... OUT_FASTA TMP_DIR")
        _add_device_flag(sp)
        sp.add_argument("--world", type=int, default=1,
                        help="spawn and supervise N cooperating ranks "
                             "(the reference's --mpi-runner analogue, "
                             "Parameters.cpp:150); output is "
                             "byte-identical to a single process")
        add_flags(sp)
    _add_stage_parsers(sub)
    args = parser.parse_args(argv)
    if getattr(args, "world", 1) > 1 and "CARPEDEAM_RANK" not in os.environ:
        return _launch_world(args.world, argv)
    try:
        if args.command in _STAGES:
            _STAGES[args.command](args)
            return 0
        return _dispatch(args)
    except ParamError as e:
        # the reference names the offending flag and exits without a
        # stack trace (Parameters.cpp parseParameters)
        print(f"{parser.prog}: invalid parameter: {e}", file=sys.stderr)
        return 1
    except FileNotFoundError as e:
        print(f"{parser.prog}: input not found: {e.filename or e}",
              file=sys.stderr)
        return 1


def _add_device_flag(sp) -> None:
    sp.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="run the CUDA kernels (default) or their plain "
                         "PyTorch versions on the CPU; not read under "
                         "--use-device 0 (the host oracles)")


def _add_stage_parsers(sub) -> None:
    """The stage subcommands' parsers: positional arguments, flags and
    defaults of carpedeam_tpu/cli.py:58-99, plus --device on those that
    reach a device stage."""
    sp = sub.add_parser("cyclecheck")
    sp.add_argument("files", nargs=2, help="IN_FASTA OUT_FASTA")
    sp.add_argument("--chop-cycle", dest="chop_cycle", type=int, default=0)
    sp.add_argument("--max-seq-len", dest="max_seq_len", type=int,
                    default=200000)

    sp = sub.add_parser("convert2fasta")
    sp.add_argument("files", nargs=2, help="DB_PREFIX OUT_FASTA")

    sp = sub.add_parser("mergereads")
    sp.add_argument("files", nargs="+", help="R1.fq R2.fq [...] OUT_DB")

    sp = sub.add_parser("createdb")
    sp.add_argument("files", nargs=2, help="IN_FASTX OUT_DB")
    sp.add_argument("--shuffle", type=int, choices=(0, 1), default=1)

    sp = sub.add_parser("kmermatcher")
    sp.add_argument("files", nargs=2, help="SEQ_DB OUT_PREF_DB")
    add_flags(sp)
    _add_device_flag(sp)

    sp = sub.add_parser("rescorediagonal")
    sp.add_argument("files", nargs=3, help="SEQ_DB PREF_DB OUT_ALN_DB")
    add_flags(sp)
    _add_device_flag(sp)

    for name in ("ancient_correction", "ancient_read_assemble",
                 "ancient_contig_merge"):
        sp = sub.add_parser(name)
        sp.add_argument("files", nargs=3, help="SEQ_DB ALN_DB OUT_SEQ_DB")
        add_flags(sp)
        if name != "ancient_contig_merge":
            _add_device_flag(sp)

    sp = sub.add_parser("guidedassembleresult")
    sp.add_argument("files", nargs=5,
                    help="NUCL_DB AA_DB ALN_DB OUT_NUCL_DB OUT_AA_DB")
    add_flags(sp)

    sp = sub.add_parser("createhdb")
    sp.add_argument("files", nargs=2, help="SEQ_DB OUT_DB")
    sp.add_argument("--cycle-keys", default="",
                    help="comma-separated keys flagged cycle:1")


def _say(msg: str) -> None:
    print(f"[carpedeam-tpu-torch] {msg}")


def _cyclecheck(args) -> None:
    from .stages.cyclecheck import cyclecheck
    # from_fastx shuffles by default, as the JAX CLI reads this FASTA
    db = SeqDB.from_fastx(args.files[0])
    cyc, _ = cyclecheck(db, chop=bool(args.chop_cycle),
                        max_seq_len=args.max_seq_len)
    cyc.to_fasta(args.files[1], headers=[str(int(k)) for k in cyc.keys])
    _say(f"{len(cyc)} circular sequences")


def _convert2fasta(args) -> None:
    SeqDB.load(args.files[0]).to_fasta(args.files[1])


def _mergereads(args) -> None:
    from .stages.mergereads import mergereads
    *fq, out = args.files
    db = mergereads(fq)
    db.save(out)
    _say(f"{len(db)} records -> {out}")


def _createdb(args) -> None:
    db = SeqDB.from_fastx(args.files[0], shuffle=bool(args.shuffle))
    db.save(args.files[1])
    _say(f"{len(db)} records -> {args.files[1]}")


def _kmermatcher(args) -> None:
    from .pipeline import _pick_kmermatcher
    p = params_from_args(args)
    db = SeqDB.load(args.files[0])
    pref = _pick_kmermatcher(p, args.device)(
        db, p.kmer_size, p.kmers_per_sequence, p.kmers_per_sequence_scale,
        p.include_only_extendable_contigs, p.hash_shift)
    pref.save(args.files[1])
    _say(f"{len(pref.qkey)} hits -> {args.files[1]}")


def _device_stage(args) -> None:
    """rescorediagonal, ancient_correction, ancient_read_assemble: the
    stage `--use-device` picks (pipeline._pick_stage_impls) on the DB's
    shared planes, as one pipeline iteration runs it; the CLI's seqId
    thresholds (ancient_correction: --min-ryseq-id-corr-reads and
    --min-seqid-corr-reads, as carpedeam_tpu/cli.py:261-264)."""
    from .aligndb import AlnDB, PrefDB
    from .pipeline import _pick_stage_impls, planes_prefetch, shared_from
    p = params_from_args(args)
    rescore_fn, correction_fn, dev, _ = _pick_stage_impls(p.use_device,
                                                          args.device)
    db = SeqDB.load(args.files[0])
    if args.command == "rescorediagonal":
        pref = PrefDB.load(args.files[1])
    else:
        aln = AlnDB.load(args.files[1])
        damage = DamageModel.load(p.ancient_damage_path)
    shared = shared_from(planes_prefetch(db, dev))
    if args.command == "rescorediagonal":
        aln = rescore_fn(db, pref, p.seq_id_thr, p.eval_thr, p.aln_len_thr,
                         **shared)
        aln.save(args.files[2])
        _say(f"{len(aln.qkey)} alignments -> {args.files[2]}")
        return
    if args.command == "ancient_correction":
        out = correction_fn(db, aln, damage, p.corr_reads_ry_seq_id,
                            p.corr_reads_seq_id, **shared)
    else:
        from .stages.read_assembly import read_assembly
        out = read_assembly(db, aln, damage, p.seq_id_thr, p.ry_seq_id_thr,
                            p.likelihood_threshold, p.random_align_penal,
                            p.excess_penal, p.max_seq_len, p.ancient_unsafe,
                            p.min_cov_safe, **shared)
    out.save(args.files[2])
    _say(f"{len(out)} records -> {args.files[2]}")


def _contig_merge(args) -> None:
    from .aligndb import AlnDB
    from .stages.contig_merge import contig_merge
    p = params_from_args(args)
    db = SeqDB.load(args.files[0])
    aln = AlnDB.load(args.files[1])
    damage = DamageModel.load(p.ancient_damage_path)
    out = contig_merge(db, aln, damage, p.merge_seq_id_thr, p.ry_seq_id_thr,
                       p.max_seq_len, p.ancient_unsafe, p.min_cov_safe)
    out.save(args.files[2])
    _say(f"{len(out)} records -> {args.files[2]}")


def _guidedassembleresult(args) -> None:
    from .aligndb import AlnDB
    from .stages.guided_assembly import guided_assembly
    p = params_from_args(args)
    nucl = SeqDB.load(args.files[0])
    aa = SeqDB.load(args.files[1])
    aln = AlnDB.load(args.files[2])
    out_n, out_a = guided_assembly(nucl, aa, aln, p.seq_id_thr,
                                   p.max_seq_len)
    out_n.save(args.files[3])
    out_a.save(args.files[4])
    _say(f"{int(out_n.ext.sum())} extended -> {args.files[3]}")


def _createhdb(args) -> None:
    # header DB 'ID len:<len> [cycle:<0|1>]' (src/util/createhdb.cpp:47-68)
    db = SeqDB.load(args.files[0])
    cyc = {int(k) for k in args.cycle_keys.split(",") if k}
    headers = []
    for i in range(len(db)):
        h = f"{i} len:{int(db.lengths[i])}"
        if cyc:
            h += f" cycle:{1 if int(db.keys[i]) in cyc else 0}"
        headers.append(h)
    db.headers = headers
    db.save(args.files[1])
    _say(f"{len(db)} headers -> {args.files[1]}")


_STAGES = {"cyclecheck": _cyclecheck, "convert2fasta": _convert2fasta,
           "mergereads": _mergereads, "createdb": _createdb,
           "kmermatcher": _kmermatcher,
           "rescorediagonal": _device_stage,
           "ancient_correction": _device_stage,
           "ancient_read_assemble": _device_stage,
           "ancient_contig_merge": _contig_merge,
           "guidedassembleresult": _guidedassembleresult,
           "createhdb": _createhdb}


def _launch_world(world: int, argv) -> int:
    """Spawn and supervise `world` rank processes of this same command
    (the RUNNER/--mpi-runner role, lib/mmseqs/src/commons/Parameters.cpp:
    150,2175): each child gets CARPEDEAM_RANK/CARPEDEAM_WORLD and runs
    the distributed pipeline on the shared tmp dir, and CARPEDEAM_COORD
    on a free local port, so the ranks meet at the torch.distributed
    barrier (rank 0 serves it).  Any rank failing terminates the group.  Unless OMP_NUM_THREADS is set, each rank gets
    an equal share of the host's cores for its OpenMP and torch threads
    (as torchrun does), so the ranks do not oversubscribe them."""
    import socket
    import subprocess
    procs: list[subprocess.Popen] = []
    threads = str(max(1, (os.cpu_count() or 1) // world))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    try:
        for r in range(world):
            env = dict(os.environ, CARPEDEAM_RANK=str(r),
                       CARPEDEAM_WORLD=str(world), CARPEDEAM_COORD=coord)
            env.setdefault("OMP_NUM_THREADS", threads)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "carpedeam_tpu_torch.cli", *argv],
                env=env))
        while True:
            codes = [p.poll() for p in procs]
            bad = next((c for c in codes if c not in (None, 0)), None)
            if bad is not None:
                print(f"[carpedeam-tpu-torch] rank failed (exit {bad}); "
                      f"group terminated", file=sys.stderr)
                return 1
            if all(c == 0 for c in codes):
                return 0
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            p.wait()


def _rank_device(device: str, rank: int) -> str:
    """A rank's device: cuda:(rank % device count) under "cuda" (raises
    without a card), the CPU under "cpu"."""
    if device == "cpu":
        return device
    from .utils import resolve_device
    resolve_device(device)
    import torch
    dev = f"cuda:{rank % torch.cuda.device_count()}"
    torch.cuda.set_device(dev)
    return dev


def _dispatch(args) -> int:
    n_reads = len(args.files) - 2
    if n_reads < 1 or (n_reads > 1 and n_reads % 2):
        raise ParamError("expected READS OUT_FASTA TMP_DIR or R1 R2 "
                         "[R1 R2 ...] OUT_FASTA TMP_DIR")
    *reads_files, out_fasta, tmp_dir = args.files
    params = params_from_args(args)
    from .utils import set_verbosity
    set_verbosity(params.verbosity)
    t0 = time.time()
    reads = _load_reads(reads_files, bool(params.db_mode))
    print(f"[carpedeam-tpu-torch] {len(reads)} reads "
          f"({reads.total_residues} residues) in {time.time()-t0:.1f}s")
    damage = DamageModel.load(params.ancient_damage_path)
    # one rank of a group (the reference's --mpi-runner contract) when
    # CARPEDEAM_RANK/WORLD say so, on a shared tmp_dir
    from .parallel.driver import DistContext
    dist = DistContext.from_env(os.path.join(tmp_dir, "dist"))
    device = args.device if dist is None or params.use_device == "0" \
        else _rank_device(args.device, dist.rank)
    with _profiler(os.environ.get("CARPEDEAM_PROFILE_DIR"),
                   "cpu" if params.use_device == "0" else args.device):
        if args.command == "ancient_assemble":
            from .pipeline import ancient_assemble
            out = ancient_assemble(
                reads, params, damage, out_fasta=out_fasta,
                tmp_dir=tmp_dir, device=device, dist=dist,
                progress=lambda m: print(f"[carpedeam-tpu-torch] {m}"))
        else:
            from .pipeline import nuclassemble
            out, _, _ = nuclassemble(
                reads, apply_nuclassemble_defaults(params), damage,
                tmp_dir=tmp_dir, device=device, dist=dist)
            if dist is not None and dist.rank != 0:
                out = None          # rank 0 writes the result
            else:
                out.headers = [f"{i} len:{int(out.lengths[i])}"
                               for i in range(len(out))]
                out.to_fasta(out_fasta)
    if out is None:
        print(f"[carpedeam-tpu-torch] rank {dist.rank}: done "
              f"({time.time()-t0:.1f}s total)")
    else:
        print(f"[carpedeam-tpu-torch] wrote {len(out)} contigs -> "
              f"{out_fasta} ({time.time()-t0:.1f}s total)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
