"""Command-line interface of the port: the reference binary's
`ancient_assemble` and `nuclassemble` commands, on the card.

    python -m carpedeam_tpu_torch.cli ancient_assemble reads.fq out.fasta \
        tmpDir --ancient-damage prefix [flags] [--device cuda|cpu]
    python -m carpedeam_tpu_torch.cli ancient_assemble R1.fq R2.fq \
        out.fasta tmpDir ...    (paired-end: FLASH-merged, mergereads)

Flag names and defaults follow src/carpedeam.cpp's command table and
LocalParameters (params.py).  CARPEDEAM_PROFILE_DIR=<dir> writes a
torch.profiler trace of the run (Chrome trace format) into <dir>.
"""
from __future__ import annotations

import argparse
import contextlib
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
    with torch.profiler.profile(activities=acts) as prof:
        yield
    os.makedirs(prof_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(prof_dir, "trace.json"))


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
        add_flags(sp)
    args = parser.parse_args(argv)
    try:
        return _dispatch(args)
    except ParamError as e:
        print(f"[carpedeam-tpu-torch] {e}", file=sys.stderr)
        return 2


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
    with _profiler(os.environ.get("CARPEDEAM_PROFILE_DIR"),
                   "cpu" if params.use_device == "0" else args.device):
        if args.command == "ancient_assemble":
            from .pipeline import ancient_assemble
            rep = ancient_assemble(
                reads, params, damage, out_fasta=out_fasta,
                tmp_dir=tmp_dir, device=args.device,
                progress=lambda m: print(f"[carpedeam-tpu-torch] {m}"))
            n_out = len(rep)
        else:
            from .pipeline import nuclassemble
            p = apply_nuclassemble_defaults(params)
            result, _, _ = nuclassemble(reads, p, damage, tmp_dir=tmp_dir,
                                        device=args.device)
            result.headers = [f"{i} len:{int(result.lengths[i])}"
                              for i in range(len(result))]
            result.to_fasta(out_fasta)
            n_out = len(result)
    print(f"[carpedeam-tpu-torch] wrote {n_out} contigs -> {out_fasta} "
          f"({time.time()-t0:.1f}s total)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
