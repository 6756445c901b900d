"""Command-line interface of the port: the reference binary's
`ancient_assemble` and `nuclassemble` commands, on the card.

    python -m carpedeam_tpu_torch.cli ancient_assemble reads.fq out.fasta \
        tmpDir --ancient-damage prefix [flags] [--device cuda|cpu]
    python -m carpedeam_tpu_torch.cli ancient_assemble R1.fq R2.fq \
        out.fasta tmpDir ...    (paired-end: FLASH-merged, mergereads)
    python -m carpedeam_tpu_torch.cli ancient_assemble ... --world 2

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
        sp.add_argument("--device", choices=("cuda", "cpu"),
                        default="cuda",
                        help="run the CUDA kernels (default) or their "
                             "plain PyTorch versions on the CPU; not read "
                             "under --use-device 0 (the host oracles)")
        sp.add_argument("--world", type=int, default=1,
                        help="spawn and supervise N cooperating ranks "
                             "(the reference's --mpi-runner analogue, "
                             "Parameters.cpp:150); output is "
                             "byte-identical to a single process")
        add_flags(sp)
    args = parser.parse_args(argv)
    if args.world > 1 and "CARPEDEAM_RANK" not in os.environ:
        return _launch_world(args.world, argv)
    try:
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
