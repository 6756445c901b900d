#!/usr/bin/env python3
"""Smoke run of carpedeam_tpu_torch on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --deep N     # phases device, build and deep alone,
                                       # on N reads
    python3 chip_smoke.py --scale N    # phases device, build and scale-run
                                       # alone, on N reads

Phases, each printing one line with the elapsed seconds:

  device    requires a CUDA device; prints the card's name and power limit
  build     builds the CUDA kernels (one nvcc call) and the host C++ library
  edges     every kernel against its plain version, bit for bit, on
            small adversarial inputs made from a numpy seed: rescore
            (row-end windows, invalid candidates, ties, codes >= 4, reverse
            rows, L not a multiple of 16), correction (slots with 0, 1 and 2
            kept records, all 44 classes, tile-crossing records, a full
            record tile, a -inf weight, records out of slot order), window
            identity (windows that wrap past the row end, empty windows,
            L=128, 384 and 512) and consensus likelihood (negative qpos0,
            'N' in both rows, targets shorter than 10, ir0/ir1 inside the
            row, records without a used column, the f32 sum included); the
            three kmer kernels on the buckets and scans of the device
            kmermatcher over a DB with 'N' bases, lowercase, duplicates,
            palindromic k-mers, sequences shorter than k and a one-row
            bucket (its PrefDB equal to the host's), and the scan on
            segments spanning its 4096-element tiles
  kernels   each kernel against its plain PyTorch version on the card, at
            the shapes its driver gives it; kernel times are device times
            from torch.profiler with the L2 cache flushed before each launch
            (from CUDA events where the profiler lost the kernels' records)
  assemble  ancient_assemble on 120,000 synthetic reads (seed 1, coverage
            20, lengths 35-120, mean 51); every kernel of the path must have
            launched and every device stage must have run records on the
            card
  kmer      the device kmermatcher (CARPEDEAM_KMER_DEVICE=1) on the run's
            first read-phase and first contig-phase SeqDB: PrefDB equal to
            the host's in all seven columns, kernels A, B, C equal to their
            plain versions with times and bounds, the torch.sort stand-ins'
            times, stage seconds on the card and on the host; then the
            120k ancient_assemble again with CARPEDEAM_KMER_DEVICE=1: its
            FASTA byte-identical, every kmermatcher call on the card, and
            the three kmer kernels launched
  repeat    nuclassemble (2 iterations) on a 15,000-read slice, twice on the
            card and once on the CPU: all three FASTA files must be equal
  use_device_1
            ancient_assemble on a 15,000-read workload (seed 2, coverage 20)
            with --use-device 1 (the tensor programs) and with the default
            kernels: equal FASTA
  paired    R1/R2 FASTQ of that workload (R1 the first 60 bases, R2 the
            reverse complement of the last 60) through the CLI's paired-end
            form on the card and on the CPU: equal FASTA
  stages    the stage subcommands in-process through the CLI on the 120k
            workload written as FASTQ: createdb, kmermatcher -k 20,
            rescorediagonal, ancient_correction, ancient_read_assemble,
            then kmermatcher, rescorediagonal and ancient_contig_merge on
            the read-phase output, createhdb, convert2fasta, cyclecheck;
            on the card (the rescore, correction, window and consensus
            kernels must launch and every device stage run records on the
            card), twice with --use-device 0 (no launch), then on the
            card again: every output file equal; then the 15k workload's
            chain on the card and on the CPU, equal; seconds of each
            subcommand on each route
  mlp       the kerasify coding MLP (57x32x64x1, random weights from a
            seed) on 120,000 feature rows on the card against the CPU
            within rtol 2e-5, atol 2e-6, with its times
  world     the CLI on the 120k workload as one process and with --world 2
            (two ranks sharing the card): equal FASTA, both walls; then the
            15k workload through the CLI as one process and as two ranks
            started here with CARPEDEAM_RANK/WORLD and CARPEDEAM_COORD (the
            torch.distributed barrier), each with its own
            CARPEDEAM_PROFILE_DIR: equal FASTA, and each rank's trace holds
            device events of the correction kernel, which its launch counts
            show too
  mesh      rescorediagonal_sharded and correction_sharded over a mesh of
            four shards on cuda:0 against the single-device --use-device 1
            stages and the host oracles on the 120k run's first read-phase
            and contig-phase SeqDBs (AlnDB text and corrected bytes equal,
            seconds of each); the CLI with --use-device mesh on the 15k
            workload (FASTA equal to the default route's); the device k-mer
            sort (sort_kmer_entries_device) against np.lexsort on the
            read-phase entry table (equal permutation, both times)
  short     BASELINE.json config 2, heavy-damage short reads (lengths
            25-120 with mean 35, terminal C->T and G->A 0.30 falling by 0.8
            a position) with --num-iter-reads-only 5 --num-iterations 14, on
            120,000 reads (seed 5): the kernel route and the host route
            (--use-device 0) write the same FASTA and grow the same
            sequences; all four kernels launch on the kernel route and
            every device stage runs records on the card
  scale     the plane derivation at the 5M run's contig-phase shared-plane
            shape (and the corrected-plane derivation at its row count):
            peak device memory within its output and a stated scratch,
            1,000 rows equal to the CPU's; then each of the four kernels at
            its largest call shape of the 5M run (`--scale 5000000`) on
            seeded synthetic rows, bit for bit against its plain version
            (chunked), with times and bounds
  deep      the deep long-contig configuration (BASELINE.json config 4:
            --unsafe 1 --min-merge-seq-id 0.97 --num-iterations 12
            --split-memory-limit 128M) on a 10-species mock community
            (seed 3, coverage 20), ancient_assemble on the kernel route
            and the host route (--use-device 0): equal FASTA; window and
            consensus launch on neither, rescore and correction in both
            phases of the kernel route; per ladder level the launches,
            the records on the card and those past the top level, the
            longest sequence after each iteration, the sub-timers; each
            level above the first against its plain version, timed
  scale-run (`--scale N` alone) the default pipeline on N reads of
            BASELINE.json config 3, a 10-species mock community (seed 4,
            coverage 20), on the kernel route, the host route and (up to
            1M reads) the device kmermatcher, each in a child process:
            equal FASTA, equal to the JAX package's where its sha256 is
            recorded (JAX_FASTA_SHA256); all four kernels launched, every
            device stage on the card; per route the wall, stage seconds,
            sub-timers, launches per ladder level, the largest call of
            each kernel, peak host RSS and peak device memory

The second-to-last line is a JSON object with each kernel's numbers
(`launches` on the assemble run, `stage_launches` on the stage chain) and
the `stages`, `mlp`, `short`, `scale` and `deep` phases' readings; the
last line is {"ok": true, "device": {...}}.  Any failed phase exits
non-zero without that line.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

T0 = time.perf_counter()
REPO = os.path.dirname(os.path.abspath(__file__))
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12      # CUDA cores (non-tensor) f32 peak


def phase(name: str, msg: str) -> None:
    print(f"[{time.perf_counter() - T0:8.2f}s] {name}: {msg}", flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


@contextlib.contextmanager
def patched(module, name: str, make):
    """module.<name> replaced by make(the function) inside the block."""
    fn = getattr(module, name)
    setattr(module, name, make(fn))
    try:
        yield
    finally:
        setattr(module, name, fn)


def cloned(args) -> tuple:
    import torch
    return tuple(a.clone() if isinstance(a, torch.Tensor) else a
                 for a in args)


def capture(module, name: str, calls: list):
    """Record the positional arguments of every call of module.<name>
    (tensors are cloned) while the drivers run; the call itself goes
    through."""
    def make(fn):
        def wrapper(*args, **kw):
            calls.append(cloned(args))
            return fn(*args, **kw)
        return wrapper
    return patched(module, name, make)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of `fn` over `reps` back-to-back calls, by CUDA
    events: the caller's view, host dispatch included."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


L2_FLUSH_BYTES = 128 << 20      # over twice the H100's 50 MB L2


# device kernels each wrapper call launches, by name, where they are not
# <name>_kernel (the correction wrapper launches its gate kernel, then the
# kernel)
DEVICE_KERNELS = {"correction": ("correction_gate", "correction_kernel"),
                  "seg_suffix_scan": ("seg_scan_kernel",)}


def kernel_ms(fn, kernels: tuple[str, ...], reps: int) -> tuple[float, str]:
    """(mean device milliseconds per call of `fn`, how they were timed).
    Before each of `reps` calls a 128 MiB write flushes the L2 cache, so
    every call reads its inputs from HBM.  "profiler": the time spent in
    the CUDA kernels whose names contain one of `kernels` (each call
    launches each once), from torch.profiler; the flush's own kernel is
    not counted.  "events": when the profiler lost the kernels' records
    in every session, CUDA events around each call (the whole call's
    device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    # the profiler now and then loses a session's kernel records: a
    # session that saw fewer than half the calls' launches of any of the
    # kernels is taken again
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        per_name = {k: [0.0, 0] for k in kernels}
        for e in prof.key_averages():
            for k in kernels:
                if k in e.key:
                    per_name[k][0] += getattr(
                        e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0.0))
                    per_name[k][1] += e.count
        if all(2 * n >= reps for _, n in per_name.values()):
            # each kernel's mean time per launch, summed over the kernels
            return sum(us / n for us, n in per_name.values()) / 1e3, \
                "profiler"
    seen = ", ".join(f"{k} {n}" for k, (_, n) in per_name.items())
    phase("kernels", f"the profiler saw under half of {reps} launches "
          f"({seen}) five times; timing with CUDA events")
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in pairs:
        flush.zero_()
        # the card spins (about 0.1 ms) while the host enqueues the call,
        # so the events time the device's work, not the host's launch
        torch.cuda._sleep(200_000)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps, "events"


def sync() -> None:
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def device_profile():
    """torch.profiler over the block: fills in the wall seconds, the
    summed device time of every device event (kernels, copies, fills;
    each once: the host ops that launched them carry the same time and
    are not counted) and the five device events with the most time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    out = {}
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        yield out
        torch.cuda.synchronize()
    out["wall_s"] = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0 and e.device_type != DeviceType.CPU:
            rows.append((us, e.key, e.count))
    rows.sort(reverse=True)
    out["device_ms"] = sum(r[0] for r in rows) / 1e3
    out["top"] = [{"op": k[:60], "ms": round(us / 1e3, 4), "calls": n}
                  for us, k, n in rows[:5]]


def plane_cells(n_rows: int, L: int, windows) -> int:
    """Distinct (row, column) cells of an (n_rows, L) plane covered by
    `windows`, each a (rows, start, width) triple of tensors: columns
    [start, start + width) of each row, taken mod L, width clipped to
    [0, L].  A byte that several windows read counts once.  Counted over
    row ranges of at most PLAIN_CELLS cells."""
    import torch
    dev = windows[0][0].device
    # each window set sorted by row, so a row range is a slice of it
    sets = []
    for rows, start, width in windows:
        rows = rows.to(torch.int64)
        order = torch.argsort(rows)
        sets.append((rows[order], start.to(torch.int64)[order] % L,
                     width.to(torch.int64)[order].clamp(0, L)))
    total = 0
    step = max(1, PLAIN_CELLS // (L + 1))
    for a in range(0, n_rows, step):
        b = min(a + step, n_rows)
        diff = torch.zeros((b - a, L + 1), dtype=torch.int32, device=dev)
        for rows, start, width in sets:
            lo_hi = torch.searchsorted(
                rows, torch.tensor([a, b], dtype=torch.int64, device=dev))
            i, j = int(lo_hi[0]), int(lo_hi[1])
            r, start = rows[i:j] - a, start[i:j]
            end = start + width[i:j]
            one = torch.ones(r.shape, dtype=torch.int32, device=dev)
            # [start, min(end, L)) and, where the window wraps, [0, end - L);
            # an empty piece adds and removes one at the same column
            for lo, hi in ((start, end.clamp(max=L)),
                           (torch.zeros_like(start),
                            (end - L).clamp(min=0))):
                diff.index_put_((r, lo), one, accumulate=True)
                diff.index_put_((r, hi), -one, accumulate=True)
        cover = diff.cumsum(dim=1, dtype=torch.int32)[:, :L]
        total += int((cover > 0).sum().item())
    return total


def bound(nbytes: int, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def synthetic_db(seed: int, n: int, lo: int, hi: int, genome_len: int):
    """n substrings (lengths lo..hi, random strand, 0.2% substitutions) of
    a random genome: contig-like sequences whose overlaps hit one plane
    width level."""
    import numpy as np

    from carpedeam_tpu_torch.io.seqdb import SeqDB
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    comp = np.zeros(256, dtype=np.uint8)
    comp[bases] = np.frombuffer(b"TGCA", dtype=np.uint8)
    genome = bases[rng.integers(0, 4, genome_len)]
    seqs = []
    for _ in range(n):
        ln = int(rng.integers(lo, hi + 1))
        s0 = int(rng.integers(0, genome_len - ln))
        s = genome[s0:s0 + ln].copy()
        mut = rng.random(ln) < 0.002
        s[mut] = bases[rng.integers(0, 4, int(mut.sum()))]
        if rng.random() < 0.5:
            s = comp[s[::-1]]
        seqs.append(s.tobytes())
    return SeqDB.from_sequences(seqs)


def kernel_inputs(damage, params, device, reads):
    """Drive the stage drivers and capture each kernel's arguments: first
    the main path's first read-phase iteration over `reads` (plane width
    128), then contig-like DBs at plane widths 512, 2048 and 4096."""
    from carpedeam_tpu_torch.kmer.matcher import kmermatcher
    from carpedeam_tpu_torch.ops import (correction_cuda, ext_cuda,
                                         extension_batch, planes,
                                         rescore_cuda, window_cuda)
    from carpedeam_tpu_torch.stages.rescorediagonal import rescorediagonal
    from carpedeam_tpu_torch.utils import bucket_len

    cap = {k: [] for k in ("rescore_pairs", "correction", "window_identity",
                           "consensus_likelihood")}
    pref = kmermatcher(reads, params.kmer_size_reads,
                       params.kmers_per_sequence,
                       params.kmers_per_sequence_scale,
                       params.include_only_extendable_reads,
                       params.hash_shift)
    pl, lens = planes.device_planes(
        reads, max_len=bucket_len(min(512, int(reads.lengths.max()))),
        device=device)
    with capture(rescore_cuda, "rescore_pairs", cap["rescore_pairs"]):
        aln = rescore_cuda.rescorediagonal_cuda(
            reads, pref, params.seq_id_thr, params.eval_thr,
            params.aln_len_thr, planes=pl, lengths=lens)
    with capture(correction_cuda, "correction_kernel", cap["correction"]):
        corr, shared = correction_cuda.correction_cuda(
            reads, aln, damage, params.corr_reads_ry_seq_id,
            params.seq_id_thr, planes=pl, lengths=lens, return_planes=True)
    check(shared is not None, "corrected planes were not derived")
    with capture(window_cuda, "window_identity", cap["window_identity"]), \
            capture(ext_cuda, "consensus_likelihood",
                    cap["consensus_likelihood"]):
        extension_batch.batch_initial_scoring(
            corr, aln, damage, params.seq_id_thr, params.ry_seq_id_thr,
            params.likelihood_threshold, params.random_align_penal,
            params.excess_penal, **shared)
    phase("kernels", f"read phase: {len(pref.qkey)} pairs, "
          f"{len(aln.qkey)} alignments")
    for seed, n, lo, hi, glen, width in ((11, 3000, 150, 500, 150_000, 512),
                                         (12, 400, 600, 2000, 150_000, 2048),
                                         (13, 150, 3000, 4090, 120_000,
                                          4096)):
        db = synthetic_db(seed, n, lo, hi, glen)
        pref = kmermatcher(db, 22, 200, 0.2, False)
        aln = rescorediagonal(db, pref, params.seq_id_thr)
        with capture(rescore_cuda, "rescore_pairs", cap["rescore_pairs"]):
            dev_aln = rescore_cuda.rescorediagonal_cuda(
                db, pref, params.seq_id_thr, device=device)
        check(dev_aln.to_text() == aln.to_text(),
              f"rescorediagonal at width {width} differs from the host "
              f"scorer")
        with capture(correction_cuda, "correction_kernel",
                     cap["correction"]):
            correction_cuda.correction_cuda(
                db, aln, damage, params.corr_reads_ry_seq_id,
                params.seq_id_thr, device=device)
        if width == 512:
            pl, lens = planes.device_planes(db, max_len=512, device=device)
            with capture(window_cuda, "window_identity",
                         cap["window_identity"]), \
                    capture(ext_cuda, "consensus_likelihood",
                            cap["consensus_likelihood"]):
                extension_batch.batch_initial_scoring(
                    db, aln, damage, params.seq_id_thr,
                    params.ry_seq_id_thr, params.likelihood_threshold,
                    params.random_align_penal, params.excess_penal,
                    planes=pl, lengths=lens)
    return cap


def kernel_row(label: str, name: str, case: str, fn, ref, nbytes: int,
               ops: float, err, note: str = "", plain_reps: int = 3) -> dict:
    """One kernel case's numbers, printed under phase `label`: the kernel's
    device time, the wrapper's and the plain version's times by CUDA
    events, and the bound of these inputs' bytes and operations."""
    ms, timer = kernel_ms(fn, DEVICE_KERNELS.get(name, (f"{name}_kernel",)),
                          20)
    wrapper_ms = cuda_ms(fn, 20)
    plain_ms = cuda_ms(ref, plain_reps)
    b_ms, b_by = bound(nbytes, ops)
    phase(label, f"{name} [{case}] ok: kernel {ms:.4f} ms "
          f"({timer}; wrapper {wrapper_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, "
          f"bound {b_ms:.4f} ms by {b_by}: {nbytes} bytes, {ops:.0f} "
          f"operations{note}; max_abs_err {err})")
    # no single PyTorch call computes any of these functions, so
    # library_ms stays null (see PERF.md)
    return {"case": case, "ms": ms, "timer": timer,
            "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "max_abs_err": err, "bytes": nbytes, "ops": ops}


def check_kernels(damage, params, device, reads) -> dict:
    """Each kernel against its plain version on the captured inputs, with
    times and bounds; returns {kernel: {"cases": [...]}}."""
    import torch

    from carpedeam_tpu_torch.ops import correction_cuda, rescore_cuda
    cap = kernel_inputs(damage, params, device, reads)
    rows = {}

    def record(name, case, fn, ref, nbytes, ops, err, note=""):
        rows.setdefault(name, {"cases": []})["cases"].append(kernel_row(
            "kernels", name, case, fn, ref, nbytes, ops, err, note))

    # ---- kernel 1: rescore (exact integers) ---------------------------
    for lo, width in ((0, 128), (128, 512), (512, 2048)):
        code2, sym2, lens, pairs = _largest(cap["rescore_pairs"], lo, width,
                                            key=3)
        out = rescore_cuda.rescore_pairs(code2, sym2, lens, pairs)
        ref = rescore_cuda.rescore_pairs_reference(code2, sym2, lens, pairs)
        sync()
        check(torch.equal(out, ref), f"rescore_pairs differs at {width}")
        # operations: one compare + one add per window column of the two
        # candidates and of the identity window
        cols, nbytes = _rescore_need(code2, lens, pairs, out)
        record("rescore_pairs", f"L={code2.shape[1]} P={pairs.shape[0]}",
               lambda: rescore_cuda.rescore_pairs(code2, sym2, lens, pairs),
               lambda: rescore_cuda.rescore_pairs_reference(code2, sym2,
                                                            lens, pairs),
               nbytes, 2.0 * cols, 0)

    # ---- kernel 2: correction (exact packed bases) --------------------
    for lo, width in ((0, 128), (128, 512), (2048, 4096)):
        args = _largest(cap["correction"], lo, width, key=1)
        out = correction_cuda.correction_kernel(*args)
        ref = correction_cuda.correction_kernel_reference(*args)
        sync()
        check(torch.equal(out, ref), f"correction differs at {width}")
        sym2, rec_rows, rscal, slot_qid, qscal, wtab, g, rt = args
        nbytes = _correction_bytes(*args, out)
        # operations: per (slot, position) cell with coverage >= 2, each
        # class with a count (F or R non-zero) x 4 bases x (2 mul + 2 add),
        # plus the 4-base prior (mul + add); a cell below 2 keeps its base
        # without a sum.  The dense count, 44 classes for every cell an
        # aligned record covers (712 operations each), is printed beside
        # it: a kernel that skips zero classes would seem to beat that one.
        ops = _correction_ops(*args)
        ops_dense = _correction_cells(rscal, g, rt) * (44 * 4 * 4 + 4 * 2)
        record("correction", f"L={sym2.shape[1]} "
               f"blocks={slot_qid.numel() // g} "
               f"G={g} R={rt}",
               lambda: correction_cuda.correction_kernel(*args),
               lambda: correction_cuda.correction_kernel_reference(*args),
               nbytes, ops, 0,
               note=f" (dense count: {ops_dense:.0f}, bound "
                    f"{bound(nbytes, ops_dense)[0]:.4f} ms)")

    # ---- kernel 3: window identity (exact integers) -------------------
    for lo, width in ((0, 128), (128, 512)):
        _check_window(_largest(cap["window_identity"], lo, width, key=1),
                      record)

    # ---- kernel 4: consensus likelihood (counts exact, f32 sum) -------
    for lo, width in ((0, 128), (128, 512)):
        _check_consensus(_largest(cap["consensus_likelihood"], lo, width,
                                  key=1), record)
    return rows


def _check_window(args, record):
    import torch

    from carpedeam_tpu_torch.ops import window_cuda
    out = window_cuda.window_identity(*args)
    ref = window_cuda.window_identity_reference(*args)
    sync()
    check(torch.equal(out, ref), "window_identity differs")
    nbytes, ops = _window_need(args, out)
    record("window_identity", f"L={args[0].shape[1]} n={args[1].numel()}",
           lambda: window_cuda.window_identity(*args),
           lambda: window_cuda.window_identity_reference(*args),
           nbytes, ops, 0)


def _window_need(args, out) -> tuple[int, float]:
    """(bytes, operations) of the window-identity kernel on these inputs:
    the window of each record's query and target rows, the record's row
    indices and the three scalars the kernel reads, and the output; two
    compares and two adds per column."""
    import torch
    sym2, qrow, trow, scal = args
    L = sym2.shape[1]
    s = scal.to(torch.int64)
    lo = s[:, 0].clamp(min=0)
    width = ((s[:, 0] + s[:, 2]).clamp(max=L) - lo).clamp(min=0)
    cells = plane_cells(sym2.shape[0], L, [
        (qrow, lo, width), (trow, lo + (s[:, 1] - s[:, 0]), width)])
    nbytes = cells + qrow.numel() * (4 + 4 + 12) + out.numel() * 4
    return nbytes, 4.0 * width.sum().item()


def _check_consensus(args, record):
    import torch

    from carpedeam_tpu_torch.ops import ext_cuda
    out = ext_cuda.consensus_likelihood(*args)
    ref = ext_cuda.consensus_likelihood_reference(*args)
    sync()
    # both sum the f32 column values strictly left to right, so all four
    # columns, the sum included, must be equal bit for bit
    check(torch.equal(out, ref), "consensus_likelihood differs from its "
          "plain version")
    nbytes, ops = _consensus_need(args, out)
    record("consensus_likelihood", f"L={args[0].shape[1]} "
           f"n={args[1].numel()}",
           lambda: ext_cuda.consensus_likelihood(*args),
           lambda: ext_cuda.consensus_likelihood_reference(*args),
           nbytes, ops, 0)


def _consensus_need(args, out) -> tuple[int, float]:
    """(bytes, operations) of the consensus kernel on these inputs: the
    columns of each record that can be used (target column in [0, tlen)
    and [ir0, ir1), query column in [0, qlen)) in its query and target
    rows, the row indices, the five scalars the kernel reads, the table
    and the output; about ten operations per column."""
    import torch
    sym2, qrow, trow, scal, wtab = args
    L = sym2.shape[1]
    s = scal.to(torch.int64)
    qpos0, qlen, tlen, ir0, ir1 = (s[:, i] for i in range(5))
    lo = torch.maximum(torch.maximum(ir0, -qpos0), torch.zeros_like(ir0))
    hi = torch.minimum(torch.minimum(tlen.clamp(max=L), ir1), qlen - qpos0)
    width = (hi - lo).clamp(min=0)
    cells = plane_cells(sym2.shape[0], L, [
        (trow, lo, width), (qrow, lo + qpos0, width)])
    nbytes = cells + qrow.numel() * (4 + 4 + 20) \
        + wtab.numel() * 4 + out.numel() * 4
    return nbytes, 10.0 * width.sum().item()


def _largest(calls, lo: int, hi: int, key: int):
    """The captured call with the most rows in argument `key` among those
    whose plane (argument 0) is wider than lo and at most hi."""
    calls = [c for c in calls if lo < c[0].shape[1] <= hi]
    check(bool(calls), f"no captured call at plane width ({lo}, {hi}]")
    return max(calls, key=lambda c: c[key].shape[0])


def _correction_cells(rscal, g: int, rec_tile: int) -> float:
    """(slot, position) cells covered by an aligned record of a slot."""
    import torch
    r = rscal.to(torch.int64)
    use = (r[:, 5] != 0) & (r[:, 6] < g)
    idx = torch.nonzero(use).flatten()
    slot = (idx // rec_tile) * g + r[idx, 6]
    qstart, alen = r[idx, 0], r[idx, 2]
    width = int(alen.max().item()) if len(idx) else 0
    off = torch.arange(width, device=rscal.device)
    cols = qstart[:, None] + off[None, :]
    ok = off[None, :] < alen[:, None]
    cells = (slot[:, None] * (1 << 20) + cols)[ok]
    return float(torch.unique(cells).numel())


def _correction_hits(sym2, rec_rows, rscal, slot_qid, qscal, wtab,
                     g: int, rec_tile: int):
    """What the correction kernel counts on these inputs, found apart from
    its plain version: (cell, class) of every counted record column (an
    aligned column of a kept record of a slot, class 0-43; cell = global
    slot * L + position) and the global slot of every kept record."""
    import torch

    from carpedeam_tpu_torch.ops.correction_cuda import _acgt_code
    L = sym2.shape[1]
    dev = sym2.device
    r = rscal.to(torch.int64)
    slot = r[:, 6]
    glob = torch.arange(r.shape[0], device=dev) // rec_tile * g + slot
    idx = torch.nonzero((r[:, 5] != 0) & (slot >= 0) & (slot < g)).flatten()
    pos = torch.arange(L, device=dev)[None, :]
    cells, classes, kept = [], [], []
    step = max(1, (1 << 24) // L)       # (records, L) cells per pass
    for lo in range(0, idx.numel(), step):
        i = idx[lo:lo + step]
        qstart, tstart, alen, tlen, smin = (r[i, k:k + 1] for k in range(5))
        q = sym2[slot_qid.to(torch.int64)[glob[i]]]
        t = sym2[rec_rows.to(torch.int64)[i]]
        t = torch.gather(t, 1, (pos + (tstart - qstart) % L) % L)
        in_aln = (pos >= qstart) & (pos < qstart + alen)
        ct_q = (q == ord("C")) | (q == ord("T"))
        ct_t = (t == ord("C")) | (t == ord("T"))
        keep = (in_aln & (ct_q == ct_t)).sum(1, keepdim=True) >= smin
        t_real = tstart + pos - qstart
        layer = torch.where(t_real < 5, t_real, 5)
        from_end = t_real - (tlen - 5)
        layer = torch.where(from_end >= 0, 6 + from_end, layer)
        cls = _acgt_code(t.to(torch.int64)) * 11 + layer
        ri, pi = (in_aln & keep & (cls >= 0) & (cls < 44)).nonzero(
            as_tuple=True)
        cells.append(glob[i][ri] * L + pi)
        classes.append(cls[ri, pi])
        kept.append(glob[i][keep[:, 0]])
    cat = (lambda xs: torch.cat(xs) if xs else
           torch.zeros(0, dtype=torch.int64, device=dev))
    return cat(cells), cat(classes), cat(kept)


def _correction_ops(*args) -> float:
    """Operations these inputs need: per cell with coverage >= 2, 16 per
    class with a count and 8 for the prior."""
    import torch
    cell, cls, _ = _correction_hits(*args)
    ucell, tot = torch.unique(cell, return_counts=True)
    busy = ucell[tot >= 2]
    pair_cell = torch.unique(cell * 64 + cls) // 64
    n_cls = int(torch.isin(pair_cell, busy).sum().item())
    return float(16 * n_cls + 8 * busy.numel())


def _plane_rows(rng, n: int, L: int, genome, lo_len: int, hi_len: int,
                noise: float):
    """(code rows, symbol rows, offsets, lengths) of n rows read from a
    code genome at random offsets, with a `noise` share of codes >= 4
    (symbol N) and lengths lo_len..hi_len."""
    import numpy as np
    off = rng.integers(0, len(genome) - L, n)
    code = np.stack([genome[o:o + L] for o in off]).astype(np.uint8)
    bad = rng.random(code.shape) < noise
    code[bad] = rng.integers(4, 256, int(bad.sum()))
    sym = np.frombuffer(b"ACGT", dtype=np.uint8)[np.minimum(code, 3)]
    sym = np.where(code < 4, sym, ord("N")).astype(np.uint8)
    return code, sym, off, rng.integers(lo_len, hi_len + 1, n)


def _rescore_edges(rng, L: int, n: int, P: int, flat: bool, device):
    """Planes and pairs that reach the rescore kernel's edges: lengths
    equal to L and beyond it (windows that wrap to the row start), codes
    >= 4, reverse query rows, invalid candidates (dist >= length), windows
    that end at the row end, and, with `flat` (identical rows of one code
    at L > 32768, where both candidates are valid), s_pos == s_neg ties."""
    import numpy as np
    import torch
    genome = rng.integers(0, 4, 4 * L).astype(np.uint8)
    if flat:
        genome[:] = 0
    code, sym, off, lens = _plane_rows(rng, 2 * n, L, genome, 1, L,
                                       0.0 if flat else 0.03)
    lens = lens[:n]
    lens[: n // 4] = L
    if not flat:
        lens[n // 4: n // 4 + 3] = L + rng.integers(1, 40, 3)
    else:
        lens[:] = L
    qidx = rng.integers(0, n, P)
    tidx = rng.integers(0, n, P)
    rev = rng.random(P) < 0.5
    qrow = qidx + np.where(rev, n, 0)
    diag = ((off[tidx] - off[qrow]) % 65536).astype(np.int64)
    kind = rng.integers(0, 6, P)
    tl, ql = lens[tidx], lens[qidx]
    diag = np.where(kind == 1, rng.integers(0, 65536, P), diag)
    # dist == length (invalid) and length - 1 (a window of one column at
    # the row end), for each candidate
    diag = np.where(kind == 2, (65536 - tl + rng.integers(0, 2, P)) % 65536,
                    diag)
    diag = np.where(kind == 3, ql - rng.integers(0, 2, P), diag)
    if flat:
        diag = np.where(kind < 3, 32768, 32768 + rng.integers(-200, 200, P))
    pairs = np.stack([qidx.astype(np.int64) | np.where(rev, -(1 << 31), 0),
                      tidx, diag], axis=1).astype(np.int32)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (code, sym, lens.astype(np.int32), pairs))


def _correction_edges(rng, L: int, g: int, rt: int, nb: int, wtab,
                      full: bool, spans: bool, device):
    """Correction blocks that reach the kernel's edges: slots with 0, 1, 2
    and many records (some dropped by the RY gate, some with no use flag),
    records near both target ends (all 11 damage layers), queries with
    was_ext, a full record tile with `full`, and with `spans` records that
    cross 128-position tile boundaries."""
    import numpy as np
    import torch
    genome = rng.integers(0, 4, 4 * L + 64).astype(np.uint8)
    n = 64
    _, sym, _, _ = _plane_rows(rng, 2 * n, L, genome, 1, L, 0.0)
    sym[rng.random(sym.shape) < 0.1] = np.frombuffer(
        b"ACGT", dtype=np.uint8)[rng.integers(0, 4, 1)]
    rscal = np.zeros((nb * rt, 8), np.int32)
    rscal[:, 6] = g                                    # no slot
    rows = np.zeros(nb * rt, np.int32)
    qscal = np.zeros((nb * g, 8), np.int32)
    slot_qid = rng.integers(0, 2 * n, nb * g).astype(np.int32)
    qscal[:, 0] = rng.integers(1, L + 1, nb * g)
    qscal[::5, 0] = L
    qscal[:, 1] = rng.random(nb * g) < 0.2
    for b in range(nb):
        counts = rng.choice([0, 0, 1, 1, 2, 2, 3, 5, 9], g)
        counts[:3] = (0, 1, 2)
        budget = rt if (full and b == 0) else rt - int(rng.integers(0, 4))
        while counts.sum() > budget:
            counts[rng.integers(3, g)] //= 2
        if full and b == 0:
            counts[g - 1] += budget - counts.sum()
        i = b * rt
        for s, c in enumerate(counts):
            qlen = int(qscal[b * g + s, 0])
            for _ in range(int(c)):
                if spans:
                    qs = 128 * int(rng.integers(1, max(2, qlen // 128 + 1))) \
                        - int(rng.integers(1, 60))
                else:
                    qs = int(rng.integers(-3, max(1, qlen)))
                alen = int(rng.integers(1, L - max(qs, 0) + 1))
                if spans:
                    alen = min(alen, int(rng.integers(100, 300)))
                ts = int(rng.integers(0, 9))
                tl = ts + alen + int(rng.integers(-3, 9))
                gate = int(rng.integers(0, 3))   # 0 any, 1 loose, 2 strict
                smin = (0, alen // 2, alen + 1)[gate]
                use = int(rng.random() < 0.9)
                rscal[i] = (qs, ts, alen, tl, smin, use, s,
                            int(rng.random() < 0.4) & use)
                rows[i] = rng.integers(0, 2 * n)
                i += 1
    return (*(torch.from_numpy(a).to(device) for a in
              (sym, rows, rscal, slot_qid, qscal,
               np.ascontiguousarray(wtab))), g, rt)


def _record_rows(rng, n: int, L: int, shift, sub_rate: float,
                 n_rate: float):
    """(2n, L) uint8 symbol rows for n records: row 2i holds record i's
    query, row 2i + 1 its target, the query rolled left by shift[i]
    (target column c = query column (c + shift[i]) mod L), then each
    row with a `sub_rate` share of random bases and an `n_rate` share of
    'N'.  The rows are shuffled; returns (rows, qrow, trow)."""
    import numpy as np
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    q = bases[rng.integers(0, 4, (n, L))]
    cols = (np.arange(L)[None, :] + np.asarray(shift)[:, None]) % L
    t = np.take_along_axis(q, cols, axis=1)
    rows = np.empty((2 * n, L), np.uint8)
    rows[0::2], rows[1::2] = q, t
    r = rng.random(rows.shape)
    rows[r < sub_rate] = bases[rng.integers(0, 4, int((r < sub_rate).sum()))]
    rows[r > 1.0 - n_rate] = ord("N")
    perm = rng.permutation(2 * n)
    inv = np.argsort(perm)
    return (rows[perm], inv[0::2].astype(np.int32),
            inv[1::2].astype(np.int32))


def window_edge_records(rng, L: int, n: int) -> dict:
    """Window-identity records that reach the kernel's edges, as numpy
    arrays (sym2, qrow, trow, scal (n, 4) = (qstart, tstart, win, 0)):
    windows that wrap past the target row's end, empty windows, windows
    cut by the query row's end, and records with unrelated rows; `kind`
    names each record's case."""
    import numpy as np
    qstart = rng.integers(0, L, n)
    win = rng.integers(1, L + 1, n)
    kind = rng.integers(0, 5, n)
    # 1: the target window wraps past the row end (tstart + win > L)
    k = kind == 1
    qstart[k] = rng.integers(0, 8, int(k.sum()))
    win[k] = rng.integers(L // 3, L - 8, int(k.sum()))
    tstart = rng.integers(0, L, n)
    tstart[k] = L - rng.integers(1, L // 3, int(k.sum()))
    win[kind == 2] = 0                                   # empty window
    k = kind == 3                                        # cut at the row end
    win[k] = L - qstart[k] + rng.integers(0, 20, int(k.sum()))
    # the target row holds the query's bases where the window reads them
    shift = (qstart - tstart) % L
    shift[kind == 4] = rng.integers(0, L, int((kind == 4).sum()))
    sym2, qrow, trow = _record_rows(rng, n, L, shift, 0.03, 0.02)
    scal = np.zeros((n, 4), np.int32)
    scal[:, 0], scal[:, 1], scal[:, 2] = qstart, tstart, win
    return {"sym2": sym2, "qrow": qrow, "trow": trow, "scal": scal,
            "kind": kind}


def consensus_edge_records(rng, L: int, n: int) -> dict:
    """Consensus-likelihood records that reach the kernel's edges, as
    numpy arrays (sym2, qrow, trow, scal (n, 8) = (qpos0, qlen, tlen,
    ir0, ir1, 0, 0, 0)): negative qpos0, 'N' in both rows, targets
    shorter than 10 (the 3' layers override the 5' ones), ir0/ir1 inside
    the row, records without a used column, and queries longer than the
    row (query columns that wrap to the row start); `kind` names each
    record's case."""
    import numpy as np
    qlen = rng.integers(L // 2, L + 1, n)
    tlen = rng.integers(1, L + 1, n)
    qpos0 = rng.integers(-L // 2, L // 2, n)
    ir0 = rng.integers(-L, 1, n)
    ir1 = rng.integers(L, 3 * L, n)
    kind = rng.integers(0, 6, n)
    k = kind == 1                                        # negative qpos0
    qpos0[k] = -rng.integers(1, L, int(k.sum()))
    k = kind == 2                                        # short targets
    tlen[k] = rng.integers(1, 10, int(k.sum()))
    qpos0[k] = rng.integers(-5, 5, int(k.sum()))
    k = kind == 3                                        # ir0/ir1 inside
    ir0[k] = rng.integers(1, L // 2, int(k.sum()))
    ir1[k] = ir0[k] + rng.integers(1, L // 2, int(k.sum()))
    k = np.nonzero(kind == 4)[0]                         # no used column
    ir1[k[0::3]] = ir0[k[0::3]] + 1 - rng.integers(1, 4, len(k[0::3]))
    qpos0[k[1::3]] = qlen[k[1::3]] + rng.integers(0, 8, len(k[1::3]))
    tlen[k[2::3]] = 0
    k = kind == 5                                        # query wraps
    qlen[k] = L + rng.integers(1, 20, int(k.sum()))
    qpos0[k] = rng.integers(0, L // 2, int(k.sum()))
    sym2, qrow, trow = _record_rows(rng, n, L, qpos0 % L, 0.02, 0.03)
    scal = np.zeros((n, 8), np.int32)
    for i, v in enumerate((qpos0, qlen, tlen, ir0, ir1)):
        scal[:, i] = v
    return {"sym2": sym2, "qrow": qrow, "trow": trow, "scal": scal,
            "kind": kind}


def check_edges(damage, device) -> None:
    """Each kernel against its plain version, bit for bit, on small
    adversarial inputs made from a numpy seed."""
    import numpy as np
    import torch

    from carpedeam_tpu_torch.ops import correction_cuda, rescore_cuda
    rng = np.random.default_rng(20261017)
    # L=8192 and 16384: per-level planes of the rescore ladder's top
    # levels, which the deep configuration's contigs reach
    for L, n, P, flat in ((100, 48, 6000, False), (128, 48, 6000, False),
                          (8192, 24, 3000, False), (16384, 12, 1500, False),
                          (33000, 6, 64, True)):
        args = _rescore_edges(rng, L, n, P, flat, device)
        out = rescore_cuda.rescore_pairs(*args)
        ref = rescore_plain(*args)
        sync()
        check(torch.equal(out, ref), f"rescore_pairs edge case L={L} "
              f"differs from its plain version")
        v = ref[:, 0].to(torch.int64) & 0xFFFFFFFF
        phase("edges", f"rescore_pairs L={L} P={P} equal: "
              f"{int(((v & 0xFFFF) == 0).sum())} without a hit, "
              f"{int((v >> 31).sum())} positive wins")
    wtab = correction_cuda.correction_wtab(damage)
    inf_tab = wtab.copy()
    inf_tab[7, 1] = -np.inf
    cases = (("L=128 full tile", 128, 128, 512, 3, wtab, True, False),
             ("L=128 -inf weight (dense path)", 128, 128, 512, 2, inf_tab,
              True, False),
             ("L=200 two tiles", 200, 32, 128, 3, wtab, False, False),
             ("L=4096 tile spans", 4096, 32, 32, 3, wtab, False, True),
             ("L=128 records out of slot order", 128, 128, 512, 2, wtab,
              False, False),
             # the correction ladder's upper levels, with the (G, R) that
             # correction_cuda picks for their planes
             ("L=2048 tile spans", 2048, *correction_cuda._tiles_for(2048),
              3, wtab, False, True),
             ("L=8192 tile spans", 8192, *correction_cuda._tiles_for(8192),
              3, wtab, False, True))
    for name, L, g, rt, nb, tab, full, spans in cases:
        args = list(_correction_edges(rng, L, g, rt, nb, tab, full, spans,
                                      device))
        if "order" in name:
            perm = torch.randperm(rt, generator=torch.Generator().manual_seed(
                1)).to(args[1].device)
            args[1] = args[1].view(nb, rt)[:, perm].reshape(-1).contiguous()
            args[2] = args[2].view(nb, rt, 8)[:, perm].reshape(-1, 8) \
                .contiguous()
        out = correction_cuda.correction_kernel(*args)
        ref = correction_plain(*args)
        sync()
        check(torch.equal(out, ref), f"correction edge case {name} differs "
              f"from its plain version")
        _, cls, kept = _correction_hits(*args)
        per_slot = torch.bincount(kept, minlength=nb * g)
        check(all((per_slot == k).any().item() for k in (0, 1, 2)),
              f"correction edge case {name} lacks a slot with 0, 1 or 2 "
              f"kept records")
        n_cls = torch.unique(cls).numel()
        if full:
            check(n_cls == 44, f"correction edge case {name} counts "
                  f"{n_cls} of the 44 classes")
        phase("edges", f"correction {name} equal: {n_cls} classes, "
              f"{int(kept.numel())} kept records, max per slot "
              f"{int(per_slot.max())}")

    from carpedeam_tpu_torch.convert import consensus_logm
    from carpedeam_tpu_torch.ops import ext_cuda, window_cuda
    on = (lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device))
    for L in (128, 384, 512):
        w = window_edge_records(rng, L, 6000)
        args = [on(w[k]) for k in ("sym2", "qrow", "trow", "scal")]
        out = window_cuda.window_identity(*args)
        ref = window_cuda.window_identity_reference(*args)
        sync()
        check(torch.equal(out, ref), f"window_identity edge case L={L} "
              f"differs from its plain version")
        kinds = np.bincount(w["kind"], minlength=5)
        phase("edges", f"window_identity L={L} n=6000 equal: {kinds[1]} "
              f"wrapping, {kinds[2]} empty, {kinds[3]} cut at the row end, "
              f"{kinds[4]} unrelated; {int(ref[:, 0].sum())} identities")
    tables = (("the damage table", consensus_logm(damage)),
              ("a random table", rng.normal(-3.0, 4.0, (11, 16))
               .astype(np.float32)))
    for L in (128, 384, 512):
        c = consensus_edge_records(rng, L, 6000)
        args = [on(c[k]) for k in ("sym2", "qrow", "trow", "scal")]
        for tname, tab in tables:
            out = ext_cuda.consensus_likelihood(*args, on(tab))
            ref = ext_cuda.consensus_likelihood_reference(*args, on(tab))
            sync()
            check(torch.equal(out, ref), f"consensus_likelihood edge case "
                  f"L={L} ({tname}) differs from its plain version")
        total = ref[:, 0].cpu().numpy()
        kind = c["kind"]
        short = (c["scal"][:, 2] < 10) & (total > 0)
        phase("edges", f"consensus_likelihood L={L} n=6000 equal, all four "
              f"columns, with the damage table and a random one: "
              f"{int((total == 0).sum())} without a used column, "
              f"{int(short.sum())} short targets used, "
              f"{int(((kind == 1) & (total > 0)).sum())} negative qpos0 "
              f"used, {int(((kind == 5) & (total > 0)).sum())} wrapping "
              f"queries used")


def _rescore_need(code2, lens, pairs, out) -> tuple[float, int]:
    """(window columns visited, bytes needed) of the rescore kernel on
    these inputs: the code bytes of both candidate windows and the symbol
    bytes of the winning window in each pair's two rows (a byte that
    several pairs read counts once), the lengths of the rows touched,
    the pairs and the output."""
    import torch
    L = code2.shape[1]
    n = lens.shape[0]
    p = pairs.to(torch.int64)
    qidx = p[:, 0] & 0x7FFFFFFF
    qrow = qidx + torch.where(p[:, 0] < 0, n, 0)
    tidx = p[:, 1]
    diag_u = p[:, 2] & 0xFFFF
    qlen = lens.to(torch.int64)[qidx]
    tlen = lens.to(torch.int64)[tidx]
    zero = torch.zeros_like(diag_u)
    dneg = 65536 - diag_u
    ok_neg = dneg < tlen
    len_neg = torch.where(ok_neg, torch.minimum(tlen - dneg, qlen), zero)
    sh_neg = torch.where(ok_neg, dneg, zero)
    ok_pos = diag_u < qlen
    len_pos = torch.where(ok_pos, torch.minimum(tlen, qlen - diag_u), zero)
    sh_pos = torch.where(ok_pos, diag_u, zero)
    # the winning window, as the kernel derives it from the packed result
    v = out[:, 0].to(torch.int64) & 0xFFFFFFFF
    use_pos = (v >> 31) == 1
    got = (v & 0xFFFF) > 0
    aln = torch.where(got, torch.where(use_pos, len_pos, len_neg), 1)
    dist = torch.where(got, torch.where(use_pos, diag_u, dneg), zero)
    q_off = torch.where(got & use_pos, dist, zero)
    t_off = torch.where(got & ~use_pos, dist, zero)
    code_cells = plane_cells(code2.shape[0], L, [
        (qrow, zero, len_neg), (tidx, sh_neg, len_neg),
        (qrow, sh_pos, len_pos), (tidx, zero, len_pos)])
    sym_cells = plane_cells(code2.shape[0], L, [
        (qrow, q_off, aln), (tidx, t_off, aln)])
    rows_touched = torch.unique(torch.cat([qidx, tidx])).numel()
    nbytes = code_cells + sym_cells + rows_touched * 4 \
        + pairs.numel() * 4 + out.numel() * 4
    cols = (len_neg.clamp(max=L) + len_pos.clamp(max=L)
            + aln.clamp(max=L)).sum().item()
    return float(cols), nbytes


def _correction_bytes(sym2, rec_rows, rscal, slot_qid, qscal, wtab, g: int,
                      rec_tile: int, out) -> int:
    """Bytes the correction kernel needs on these inputs: every column of
    each slot's query row, the aligned window of each record's row, the
    scalars it reads (all eight of a record of a slot, the slot field of
    a padding record, two of a slot), the table and the output."""
    import torch
    L = sym2.shape[1]
    r = rscal.to(torch.int64)
    mine = r[:, 6] < g
    lo = r[:, 0].clamp(min=0)
    width = ((r[:, 0] + r[:, 2]).clamp(max=L) - lo).clamp(min=0)
    idx = torch.nonzero(mine).flatten()
    cells = plane_cells(sym2.shape[0], L, [
        (slot_qid, torch.zeros_like(slot_qid), torch.full_like(slot_qid, L)),
        (rec_rows[idx], lo[idx] + (r[idx, 1] - r[idx, 0]), width[idx])])
    n_mine = int(mine.sum().item())
    return cells + n_mine * (4 + 32) + (rscal.shape[0] - n_mine) * 4 \
        + slot_qid.numel() * (4 + 8) + wtab.numel() * 4 + out.numel()


# ---- the device kmermatcher: kernels A, B and C ---------------------------

PREF_COLUMNS = ("qkey", "tkey", "score", "diag", "starts", "qkeys", "qext")

def same_prefdb(a, b) -> bool:
    """All seven PrefDB columns equal."""
    import numpy as np
    return all(np.array_equal(np.asarray(getattr(a, c)),
                              np.asarray(getattr(b, c)))
               for c in PREF_COLUMNS)


def kmer_edge_db(rng):
    """A SeqDB that reaches the device kmermatcher's edges: overlapping
    reads of a random genome with 'N' bases and lowercase stretches,
    exact duplicates, palindromic k-mers (ACGT repeats and embedded
    reverse-complement palindromes), sequences shorter than k, and one
    length bucket holding a single row (700 bases, bucket 768, where
    the selection compacts); about 2 of every 10 sequences extended."""
    import numpy as np

    from carpedeam_tpu_torch.io.seqdb import SeqDB
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    comp = np.zeros(256, dtype=np.uint8)
    comp[bases] = np.frombuffer(b"TGCA", dtype=np.uint8)
    genome = bases[rng.integers(0, 4, 20_000)]
    seqs = []
    for _ in range(2400):
        ln = int(rng.integers(30, 121))
        s0 = int(rng.integers(0, len(genome) - ln))
        s = genome[s0:s0 + ln].copy()
        if rng.random() < 0.5:
            s = comp[s[::-1]]
        r = rng.random()
        if r < 0.1:
            s[rng.integers(0, ln, int(rng.integers(1, 4)))] = ord("N")
        elif r < 0.2:
            a = int(rng.integers(0, ln))
            s[a:a + 25] = s[a:a + 25] | 0x20            # lowercase
        seqs.append(s.tobytes())
    seqs += seqs[:40]                                  # exact duplicates
    for i in range(30):                                # palindromes
        half = bases[rng.integers(0, 4, 10 + i % 7)]
        core = np.concatenate([half, comp[half[::-1]]])
        flank = genome[200 * i:200 * i + 30]
        seqs.append(np.concatenate([flank, core, flank[::-1]]).tobytes())
    seqs += [b"ACGT" * 25, b"ACGT" * 12 + b"A", b"TTAA" * 9]
    seqs += [genome[5 * i:5 * i + 5 + i].tobytes() for i in range(15)]
    seqs.append(genome[5000:5700].tobytes())           # the single-row bucket
    ext = rng.random(len(seqs)) < 0.2
    return SeqDB.from_sequences(seqs, ext=ext)


def scan_edge_inputs(rng, M: int, mode: int, device):
    """Inputs of kernel C's two scans: (s, j, flags) for the argmax with
    many ties in s, or (v, flags) for the OR; flags sparse, and none in
    [3000, 9000), so one segment spans the first tile boundaries (tiles
    of 4096)."""
    import numpy as np
    import torch
    f = rng.random(M) < (0.01 if mode == 0 else 0.02)
    f[3000:9000] = False
    on = (lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device))
    if mode == 0:
        return (on(rng.integers(1, 40, M).astype(np.int64)),
                on(np.arange(M, dtype=np.int64)), on(f))
    return on(rng.random(M) < 0.05), on(f)


def check_kmer_edges(device) -> None:
    """Kernels A, B and C against their plain versions, bit for bit, on
    the inputs the device kmermatcher gives them on kmer_edge_db (both
    phases' settings) and on scan_edge_inputs; and the device
    kmermatcher's PrefDB against the host's there."""
    import numpy as np
    import torch

    from carpedeam_tpu_torch.kmer.matcher import kmermatcher
    from carpedeam_tpu_torch.ops import kmer_device as K
    rng = np.random.default_rng(20261018)
    db = kmer_edge_db(rng)
    for k, kps, only_ext in ((20, 200, False), (22, 60, True)):
        cap = {n: [] for n in ("kmer_windows", "select_walk",
                               "seg_suffix_scan")}
        with capture(K, "kmer_windows", cap["kmer_windows"]), \
                capture(K, "select_walk", cap["select_walk"]), \
                capture(K, "seg_suffix_scan", cap["seg_suffix_scan"]):
            dev = K.kmermatcher_device(db, k, kps, 0.2, only_ext,
                                       device=device)
        host = kmermatcher(db, k, kps, 0.2, only_ext)
        check(same_prefdb(dev, host), f"device kmermatcher (k={k}) differs "
              f"from the host's on the edge DB")
        _check_kmer_calls(cap)
        shapes = [tuple(c[0].shape) for c in cap["kmer_windows"]]
        phase("edges", f"kmermatcher k={k} kps={kps} only_ext={only_ext}: "
              f"{len(db)} sequences, {len(host.qkey)} PrefDB rows equal to "
              f"the host's; kernels A, B, C equal on buckets {shapes} and "
              f"{len(cap['seg_suffix_scan'])} scans")
    for M in (1, 4095, 4096, 4097, 3 * 4096 + 123, 40_000):
        for mode in (K.SCAN_ARGMAX, K.SCAN_OR):
            xs = scan_edge_inputs(rng, M, mode, device)
            out = K.seg_suffix_scan(mode, *xs)
            ref = K.tiled_suffix_scan_reference(mode, xs)
            sync()
            check(all(torch.equal(a, b) for a, b in zip(out, ref)),
                  f"seg_suffix_scan mode {mode} M={M} differs from its "
                  f"plain version")
    phase("edges", "seg_suffix_scan equal on M = 1, 4095, 4096, 4097, "
          "12411, 40000 (both scans; one segment spans [3000, 9000))")


def _check_kmer_calls(cap) -> None:
    """Every captured kernel A, B, C call against its plain version."""
    import torch

    from carpedeam_tpu_torch.ops import kmer_device as K
    for codes, lens, k, seed in cap["kmer_windows"]:
        out = K.kmer_windows(codes, lens, k, seed)
        ref = (K.identity_hash_reference(codes, lens, seed),
               *K.windows_bucket_reference(codes, lens, k, seed))
        sync()
        check(all(torch.equal(a, b) for a, b in zip(out, ref)),
              f"kmer_windows differs at {tuple(codes.shape)}")
    for key2s, lens, k, kps, scale in cap["select_walk"]:
        out = K.select_walk(key2s, lens, k, kps, scale)
        ref = K.select_bucket_reference(key2s, lens, k, kps, scale)
        sync()
        check(torch.equal(out, ref),
              f"select_walk differs at {tuple(key2s.shape)}")
    for mode, *xs in cap["seg_suffix_scan"]:
        out = K.seg_suffix_scan(mode, *xs)
        ref = K.tiled_suffix_scan_reference(mode, xs)
        sync()
        check(all(torch.equal(a, b) for a, b in zip(out, ref)),
              f"seg_suffix_scan mode {mode} differs at M={xs[0].numel()}")


def check_kmer(dbs: dict, params, device) -> dict:
    """Phase `kmer`: the device kmermatcher against the host's on the
    main path's SeqDBs (`dbs`: phase -> (SeqDB, k, only_ext)), each
    kernel against its plain version at the read-phase shapes with its
    times and bound, the torch.sort stand-ins' times, and the stage's
    seconds on the card and on the host.  Returns {kernel: {"cases"}}."""
    import torch

    from carpedeam_tpu_torch.kmer.matcher import kmermatcher
    from carpedeam_tpu_torch.ops import kmer_device as K
    rows = {}
    kps, scale = params.kmers_per_sequence, params.kmers_per_sequence_scale
    for name, (db, k, only_ext) in dbs.items():
        def dev_run():
            out = K.kmermatcher_device(db, k, kps, scale, only_ext,
                                       params.hash_shift, device=device)
            sync()
            return out

        def host_run():
            return kmermatcher(db, k, kps, scale, only_ext,
                               params.hash_shift)
        cap = {n: [] for n in ("kmer_windows", "select_walk",
                               "seg_suffix_scan", "rowsort_bucket",
                               "global_sort", "sort_pairs")}
        with contextlib.ExitStack() as stack:
            for n, calls in cap.items():
                stack.enter_context(capture(K, n, calls))
            dev = dev_run()
        host = host_run()
        check(same_prefdb(dev, host), f"device kmermatcher differs from the "
              f"host's on the {name} DB")
        dev_s = _best_seconds(dev_run, 3)
        host_s = _best_seconds(host_run, 3)
        phase("kmer", f"{name} DB: {len(db)} sequences, k={k}: PrefDB "
              f"({len(host.qkey)} rows) equal to the host's in all seven "
              f"columns; stage seconds device {dev_s:.4f}, host "
              f"{host_s:.4f} (best of 3)")
        if name != "read-phase":
            continue
        with device_profile() as prof:
            dev_run()
        phase("kmer", f"profiled device kmermatcher: device busy "
              f"{prof['device_ms']:.3f} ms of {prof['wall_s']:.3f} s "
              "(profiled wall); top device ops " + json.dumps(prof["top"]))
        _check_kmer_calls(cap)
        _time_kmer_kernels(cap, rows)
        for n in ("rowsort_bucket", "global_sort", "sort_pairs"):
            args = cap[n][0]
            ms = cuda_ms(lambda: getattr(K, n)(*args), 5)
            rows.setdefault("sorts", {})[n] = ms
            phase("kmer", f"torch.sort stand-in {n} "
                  f"{[tuple(a.shape) for a in args]}: {ms:.4f} ms (CUDA "
                  f"events, 5 calls)")
        rows["stage_s"] = {"device": dev_s, "host": host_s}
    return rows


def _best_seconds(fn, reps: int) -> float:
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _time_kmer_kernels(cap, rows) -> None:
    """Times and bounds of kernels A, B and C on the captured read-phase
    inputs.  Operations are counted as 64-bit integer operations and held
    against the f32 rate (no 64-bit integer rate is published), so the
    operations bound is a lower one; every case is bound by bytes."""
    from carpedeam_tpu_torch.ops import kmer_device as K

    def record(name, case, fn, ref, nbytes, ops):
        ms, timer = kernel_ms(fn, DEVICE_KERNELS.get(name,
                                                     (f"{name}_kernel",)), 20)
        plain_ms = cuda_ms(ref, 3)
        b_ms, b_by = bound(nbytes, ops)
        rows.setdefault(name, {"cases": []})["cases"].append({
            "case": case, "ms": ms, "timer": timer,
            "wrapper_ms": cuda_ms(fn, 20), "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "max_abs_err": 0, "bytes": nbytes, "ops": ops})
        phase("kmer", f"{name} [{case}] equal: kernel {ms:.4f} ms ({timer}; "
              f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by}: "
              f"{nbytes} bytes, {ops:.0f} operations)")

    codes, lens, k, seed = max(cap["kmer_windows"],
                               key=lambda c: c[0].numel())
    B, L = codes.shape
    W = max(L - k + 1, 0)
    # bytes: the code plane and lengths in; the hash, key2 and pos_strand
    # out; operations: per window k packing steps, the reverse complement
    # and the xxh64 (about 60), per row two a column of the hash
    record("kmer_windows", f"B={B} L={L} W={W}",
           lambda: K.kmer_windows(codes, lens, k, seed),
           lambda: (K.identity_hash_reference(codes, lens, seed),
                    K.windows_bucket_reference(codes, lens, k, seed)),
           B * L + 4 * B + 8 * B + 12 * B * W,
           float(B * W * (3 * k + 60) + 2 * int(lens.sum())))
    key2s, lens, k, kps, scale = max(cap["select_walk"],
                                     key=lambda c: c[0].numel())
    B, W = key2s.shape
    # bytes: the sorted rows and lengths in, the hits out; operations:
    # about ten a window over the three passes
    record("kmer_select", f"B={B} W={W}",
           lambda: K.select_walk(key2s, lens, k, kps, scale),
           lambda: K.select_bucket_reference(key2s, lens, k, kps, scale),
           9 * B * W + 4 * B, float(10 * B * W))
    for mode, *xs in cap["seg_suffix_scan"]:
        M = xs[0].numel()
        nbytes = M * (17 + 16) if mode == K.SCAN_ARGMAX else M * 3
        record("seg_suffix_scan",
               f"{'argmax' if mode == K.SCAN_ARGMAX else 'or'} M={M}",
               lambda: K.seg_suffix_scan(mode, *xs),
               lambda: K.tiled_suffix_scan_reference(mode, xs),
               nbytes, float(6 * M))


# kernels of the device kmermatcher, launched only under
# CARPEDEAM_KMER_DEVICE=1
KMER_KERNELS = ("kmer_windows", "kmer_select", "seg_suffix_scan")


def run_assemble(label: str, reads, params, damage, out_dir: str,
                 kmer_device: bool, device: str = "cuda",
                 hooks=contextlib.nullcontext) -> dict:
    """ancient_assemble on `device` (CARPEDEAM_KMER_DEVICE=1 or 0) with
    the launch counts and coverage set to 0 just before and read just
    after, inside the context `hooks()`; prints the wall and stage
    seconds.  Returns wall, stages, launches, coverage and the FASTA
    bytes."""
    from carpedeam_tpu_torch import _build, utils
    from carpedeam_tpu_torch.pipeline import ancient_assemble
    path = os.path.join(out_dir, f"{label}_{int(kmer_device)}_"
                                 f"{params.use_device}.fasta")
    old = os.environ.get("CARPEDEAM_KMER_DEVICE")
    os.environ["CARPEDEAM_KMER_DEVICE"] = "1" if kmer_device else "0"
    timer = utils.StageTimer()
    try:
        with hooks():
            _build.reset_launch_counts()
            utils.coverage_reset()
            t0 = time.perf_counter()
            rep = ancient_assemble(reads, params, damage, out_fasta=path,
                                   device=device, timer=timer)
            sync()
            wall = time.perf_counter() - t0
            launches = _build.launch_counts()
            coverage = utils.coverage_summary()
    finally:
        if old is None:
            del os.environ["CARPEDEAM_KMER_DEVICE"]
        else:
            os.environ["CARPEDEAM_KMER_DEVICE"] = old
    stages: dict[str, float] = {}
    for stage, secs in timer.summary().items():
        key = stage.rsplit("_", 1)[0] if stage[-1].isdigit() else stage
        stages[key] = stages.get(key, 0.0) + secs
    what = (f"{len(reads)} reads, --use-device {params.use_device}, "
            f"CARPEDEAM_KMER_DEVICE={int(kmer_device)}")
    phase(label, f"{what}: {len(rep)} contigs in {wall:.2f} s; stage "
          "seconds " + json.dumps({k: round(v, 3) for k, v in stages.items()}))
    phase(label, "coverage " + json.dumps(coverage))
    phase(label, "launches " + json.dumps(launches))
    check(len(rep) > 0, "no contigs")
    check(all(int(rep.lengths[i]) >= params.min_contig_len
              for i in range(len(rep))), "contig shorter than the minimum")
    with open(path, "rb") as fh:
        fasta = fh.read()
    return {"wall": wall, "stages": stages, "launches": launches,
            "coverage": coverage, "fasta": fasta}


def write_paired(db, r1: str, r2: str, n: int = 60) -> None:
    """R1/R2 FASTQ of the reads of `db`: R1 the first n bases, R2 the
    reverse complement of the last n, constant qualities."""
    import numpy as np
    comp = np.full(256, ord("N"), dtype=np.uint8)
    comp[np.frombuffer(b"ACGTacgt", np.uint8)] = np.frombuffer(b"TGCAtgca",
                                                             np.uint8)
    with open(r1, "w") as f1, open(r2, "w") as f2:
        for i in range(len(db)):
            s = db.seq_bytes(i)
            a = s[:n].tobytes().decode()
            b = comp[s[-n:][::-1]].tobytes().decode()
            f1.write(f"@p{i}/1\n{a}\n+\n{'I' * len(a)}\n")
            f2.write(f"@p{i}/2\n{b}\n+\n{'I' * len(b)}\n")


def write_profiles(prefix: str, sub5p, sub3p) -> None:
    """<prefix>5p.prof / <prefix>3p.prof damage profiles of these rates."""
    head = "\t".join(f"{a}>{b}" for a in "ACGT" for b in "ACGT" if a != b)
    for suffix, rates in (("5p.prof", sub5p), ("3p.prof", sub3p)):
        with open(prefix + suffix, "w") as fh:
            fh.write(head + "\n")
            for row in rates:
                fh.write("\t".join(repr(float(x)) for x in row) + "\n")


def check_paired(db, rates, out_dir: str) -> None:
    """Phase `paired`: R1/R2 FASTQ of the slice through the CLI's
    paired-end form on the card and on the CPU; the FASTA files must be
    equal."""
    r1 = os.path.join(out_dir, "paired_R1.fq")
    r2 = os.path.join(out_dir, "paired_R2.fq")
    write_paired(db, r1, r2)
    prefix = os.path.join(out_dir, "paired_damage_")
    write_profiles(prefix, *rates)
    fastas = []
    for dev in ("cuda", "cpu"):
        out = os.path.join(out_dir, f"paired_{dev}.fasta")
        cmd = [sys.executable, "-m", "carpedeam_tpu_torch.cli",
               "ancient_assemble", r1, r2, out,
               os.path.join(out_dir, f"paired_tmp_{dev}"),
               "--ancient-damage", prefix, "--device", dev, "-v", "2"]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=400, cwd=os.path.dirname(
                                 os.path.abspath(__file__)))
        check(res.returncode == 0, f"paired-end CLI on {dev} failed "
              f"({res.returncode}): {res.stderr[-2000:]}")
        with open(out, "rb") as fh:
            fastas.append(fh.read())
        reads_line = next((ln for ln in res.stdout.splitlines()
                           if " reads (" in ln), "")
        phase("paired", f"{dev}: {time.perf_counter() - t0:.2f} s, "
              f"{reads_line.strip()}; {len(fastas[-1])} FASTA bytes")
    check(fastas[0] == fastas[1], "the paired-end CUDA and CPU FASTA differ")
    check(fastas[0].startswith(b">0 len:"), "the paired-end run wrote no "
          "contig")
    phase("paired", "paired-end FASTA byte-identical on the card and on the "
          "CPU")


def write_fasta(db, path: str) -> None:
    with open(path, "w") as fh:
        for i in range(len(db)):
            fh.write(f">r{i}\n{db.seq_str(i)}\n")


def write_fastq(db, path: str) -> None:
    with open(path, "w") as fh:
        for i in range(len(db)):
            s = db.seq_str(i)
            fh.write(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n")


def dir_contents(path: str) -> dict:
    """name -> contents of every file in `path`: an .npz checkpoint
    (SeqDB, PrefDB, AlnDB) as {member: bytes}, since the zip container
    stamps each member with its write time; any other file (FASTA,
    .headers) as its bytes."""
    import zipfile
    out = {}
    for name in sorted(os.listdir(path)):
        full = os.path.join(path, name)
        if name.endswith(".npz"):
            with zipfile.ZipFile(full) as z:
                out[name] = {m: z.read(m) for m in z.namelist()}
        else:
            with open(full, "rb") as fh:
                out[name] = fh.read()
    return out


# the kernels the stage subcommands launch on the kernel route
STAGE_KERNELS = ("rescore_pairs", "correction", "window_identity",
                 "consensus_likelihood")


def stage_chain(fq: str, prefix: str, work: str, device: str,
                extra=()) -> dict:
    """The stage subcommands, in-process through the port's cli.main, on
    FASTQ `fq` with the damage profiles at `prefix`: createdb,
    kmermatcher -k 20, rescorediagonal, ancient_correction,
    ancient_read_assemble; kmermatcher (contig k 22), rescorediagonal
    and ancient_contig_merge on the read-phase output; createhdb,
    convert2fasta, and cyclecheck on that FASTA.  Outputs in `work`
    (emptied first); `extra` goes to the subcommands that take --device.
    Returns the seconds of each step (the card synchronised after each)."""
    import io
    import shutil

    import torch

    from carpedeam_tpu_torch import cli
    shutil.rmtree(work, ignore_errors=True)     # dir_contents reads it all
    os.makedirs(work)

    def p(name):
        return os.path.join(work, name)
    dev = ["-v", "2", "--device", device, *extra]
    dmg = ["--ancient-damage", prefix]
    steps = [
        ("createdb", [fq, p("reads")]),
        ("kmermatcher", [p("reads"), p("pref"), "-k", "20",
                         "--include-only-extendable", "0", *dev]),
        ("rescorediagonal", [p("reads"), p("pref"), p("aln"), *dev]),
        ("ancient_correction", [p("reads"), p("aln"), p("corr"), *dmg,
                                *dev]),
        ("ancient_read_assemble", [p("corr"), p("aln"), p("asm"), *dmg,
                                   *dev]),
        ("kmermatcher", [p("asm"), p("pref2"), *dev]),
        ("rescorediagonal", [p("asm"), p("pref2"), p("aln2"), *dev]),
        ("ancient_contig_merge", [p("asm"), p("aln2"), p("cm"), *dmg,
                                  "-v", "2"]),
        ("createhdb", [p("cm"), p("cm_h")]),
        ("convert2fasta", [p("cm_h"), p("cm.fa")]),
        ("cyclecheck", [p("cm.fa"), p("cyc.fa")]),
    ]
    secs = {}
    for command, args in steps:
        label = command if command not in secs else f"{command}_contigs"
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            rc = cli.main([command, *args])
        if device == "cuda":
            torch.cuda.synchronize()
        secs[label] = time.perf_counter() - t0
        check(rc == 0, f"{command} {' '.join(extra)} on {device} failed "
              f"({rc}): {log.getvalue()[-2000:]}")
    return secs


def check_stages(reads, w15, rates, out_dir: str) -> dict:
    """Phase `stages`: the stage chain (stage_chain) on the 120k workload
    on the card, with the launch counts and coverage set to 0 just before
    and read just after: the rescore, correction, window and consensus
    kernels launched and every device stage ran records on the card; the
    same chain twice with --use-device 0 (the host oracles; no launch),
    then on the card again; the 15k workload's chain on the card and on
    the CPU.  Every output file equal across the runs.  Returns seconds
    (two runs a route), launches and coverage."""
    from carpedeam_tpu_torch import _build, utils
    prefix = os.path.join(out_dir, "stages_damage_")
    write_profiles(prefix, *rates)
    fq = os.path.join(out_dir, "stages_120k.fq")
    write_fastq(reads, fq)
    _build.reset_launch_counts()
    utils.coverage_reset()
    card = stage_chain(fq, prefix, os.path.join(out_dir, "stages_cuda"),
                       "cuda")
    launches = _build.launch_counts()
    coverage = utils.coverage_summary()
    for k in STAGE_KERNELS:
        check(launches[k] > 0, f"kernel {k} was not launched by the stage "
              "subcommands")
    for stage in ("rescorediagonal", "correction", "extension_scoring"):
        d = coverage.get(stage)
        check(d is not None and d["device"] > 0,
              f"stage subcommand {stage} ran no records on the card")
    # then host, host, card: the card and host routes in turns (ABBA),
    # so neither has the warmer caches
    _build.reset_launch_counts()
    host = [stage_chain(fq, prefix, os.path.join(out_dir, f"stages_host{i}"),
                        "cuda", ("--use-device", "0")) for i in range(2)]
    check(all(n == 0 for n in _build.launch_counts().values()),
          "--use-device 0 launched a kernel")
    card = [card, stage_chain(fq, prefix,
                              os.path.join(out_dir, "stages_cuda1"), "cuda")]
    files = dir_contents(os.path.join(out_dir, "stages_cuda"))
    for other in ("stages_host0", "stages_host1", "stages_cuda1"):
        check(files == dir_contents(os.path.join(out_dir, other)),
              f"the stage chain's outputs differ between the card and "
              f"{other}")
    phase("stages", f"120k chain: {len(files)} output files equal on the "
          "card and on the host route (--use-device 0), twice each")
    phase("stages", "launches " + json.dumps(launches))
    phase("stages", "coverage " + json.dumps(coverage))
    for label, runs in (("card", card), ("host route", host)):
        phase("stages", f"seconds on the {label}, two runs " + json.dumps(
            {k: [round(r[k], 3) for r in runs] for k in runs[0]}))
    fq15 = os.path.join(out_dir, "stages_15k.fq")
    write_fastq(w15, fq15)
    small = {}
    for dev in ("cuda", "cpu"):
        small[dev] = stage_chain(fq15, prefix,
                                 os.path.join(out_dir, f"stages15_{dev}"),
                                 dev)
    files15 = dir_contents(os.path.join(out_dir, "stages15_cuda"))
    check(files15 == dir_contents(os.path.join(out_dir, "stages15_cpu")),
          "the 15k stage chain's outputs differ between the card and the "
          "CPU")
    phase("stages", f"15k chain: {len(files15)} output files equal on the "
          f"card ({sum(small['cuda'].values()):.2f} s) and on the CPU "
          f"({sum(small['cpu'].values()):.2f} s)")
    return {"card_s": card, "host_s": host, "launches": launches,
            "coverage": coverage, "cpu15k_s": small["cpu"],
            "card15k_s": small["cuda"]}


def write_kerasify(path: str, layers) -> None:
    """A kerasify model file (little-endian, kerasify's keras_model.cpp
    layout): ("dense", W (in, out), b, activation), ("act", activation),
    ("flatten",) and ("elu", alpha) in order."""
    import struct

    import numpy as np
    with open(path, "wb") as fh:
        fh.write(struct.pack("<I", len(layers)))
        for kind, *rest in layers:
            if kind == "dense":
                w, b, act = rest
                fh.write(struct.pack("<IIII", 1, *w.shape, len(b)))
                fh.write(np.asarray(w, "<f4").tobytes())
                fh.write(np.asarray(b, "<f4").tobytes())
                fh.write(struct.pack("<I", act))
            elif kind == "act":
                fh.write(struct.pack("<II", 5, rest[0]))
            elif kind == "flatten":
                fh.write(struct.pack("<I", 3))
            else:
                fh.write(struct.pack("<If", 4, rest[0]))


def coding_layers(seed: int) -> list:
    """Random 57x32x64x1 kerasify layers (relu, relu, sigmoid), the shape
    of the bundled predict_coding_acc9743_57x32x64 model."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = []
    for n_in, n_out, act in ((57, 32, 2), (32, 64, 2), (64, 1, 4)):
        w = rng.normal(0.0, 1.0 / np.sqrt(n_in), (n_in, n_out))
        out.append(("dense", w.astype(np.float32),
                    rng.normal(0.0, 0.1, n_out).astype(np.float32), act))
    return out


MLP_RTOL, MLP_ATOL = 2e-5, 2e-6


def check_mlp(out_dir: str) -> dict:
    """Phase `mlp`: the kerasify coding MLP (57x32x64x1) on 120,000
    feature rows on the card against the CPU, within rtol 2e-5 and atol
    2e-6; the forward pass's time on the card (CUDA events) and on the
    CPU, and coding_scores's (file load, copies and forward)."""
    import numpy as np
    import torch

    from carpedeam_tpu_torch.ops.coding_mlp import (KerasifyModel,
                                                    coding_scores)
    path = os.path.join(out_dir, "coding_57x32x64.model")
    write_kerasify(path, coding_layers(5))
    rng = np.random.default_rng(6)
    x = ((rng.random((120_000, 57)) - 0.5) * 0.2).astype(np.float32)
    model = KerasifyModel.load(path)
    net_cpu, net_gpu = model.module("cpu"), model.module("cuda")
    xg = torch.from_numpy(x).cuda()
    with torch.no_grad():
        t0 = time.perf_counter()
        want = net_cpu(torch.from_numpy(x)).numpy()
        cpu_ms = (time.perf_counter() - t0) * 1e3
        got = net_gpu(xg).cpu().numpy()
        card_ms = cuda_ms(lambda: net_gpu(xg), 20)
    t0 = time.perf_counter()
    scores = coding_scores(path, x)
    scores_ms = (time.perf_counter() - t0) * 1e3
    err = float(np.abs(got.astype(np.float64) - want).max())
    # the least time: each input, weight and output byte once, and the
    # dense layers' multiply-adds (the activations are under it) at the
    # f32 rate outside the tensor cores
    dense = [(w, b) for kind, w, b, _ in model.layers if kind == "dense"]
    nbytes = x.nbytes + got.nbytes + sum(w.nbytes + b.nbytes
                                         for w, b in dense)
    ms_bound, bound_by = bound(nbytes, sum(2 * len(x) * w.size
                                           for w, _ in dense))
    check(got.shape == (120_000, 1) and np.isfinite(got).all(),
          "MLP output shape or values")
    check(bool(np.allclose(got, want, rtol=MLP_RTOL, atol=MLP_ATOL)),
          f"MLP on the card differs from the CPU (max abs err {err})")
    check(bool(np.allclose(scores, want, rtol=MLP_RTOL, atol=MLP_ATOL)),
          "coding_scores on the card differs from the CPU")
    phase("mlp", f"120,000 x 57 rows: card == CPU within rtol {MLP_RTOL} "
          f"atol {MLP_ATOL} (max abs err {err:.3g}); forward {card_ms:.4f} "
          f"ms on the card (CUDA events; bound {ms_bound:.4f} ms by "
          f"{bound_by}), {cpu_ms:.2f} ms on the CPU; coding_scores "
          f"{scores_ms:.2f} ms")
    return {"rows": 120_000, "max_abs_err": err, "ms": card_ms,
            "bound_ms": ms_bound, "bound_by": bound_by, "cpu_ms": cpu_ms,
            "coding_scores_ms": scores_ms}


def cli_command(reads: str, out: str, prefix: str, device: str) -> list:
    """The CLI's ancient_assemble on `reads` into `out`, with a fresh tmp
    dir beside it."""
    return [sys.executable, "-m", "carpedeam_tpu_torch.cli",
            "ancient_assemble", reads, out, out + ".tmp", "--ancient-damage",
            prefix, "--device", device, "-v", "2"]


def cli_assemble(label: str, reads: str, out: str, prefix: str, device: str,
                 extra=(), env=None):
    """cli_command run to its end; returns (FASTA bytes, seconds, its
    stdout and stderr).  The CLI runs in a session of its own, so a
    timeout kills the ranks that `--world` started too."""
    import signal
    t0 = time.perf_counter()
    proc = subprocess.Popen(cli_command(reads, out, prefix, device)
                            + list(extra), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=REPO,
                            env=env, start_new_session=True)
    try:
        outs, err = proc.communicate(timeout=400)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    secs = time.perf_counter() - t0
    check(proc.returncode == 0, f"{label}: CLI {' '.join(extra)} failed "
          f"({proc.returncode}): {err[-2000:]}")
    with open(out, "rb") as fh:
        return fh.read(), secs, outs + err


def stage_split(log: str, top: int = 14) -> dict:
    """Seconds by stage and sub-step from a CLI log taken with
    CARPEDEAM_SUBTIMING=1 (stage lines on stdout, `## name: secs` lines
    on stderr), summed over iterations and over the ranks that wrote the
    log; the `top` largest."""
    import re
    out: dict[str, float] = {}
    for m in re.finditer(r"^(?:\[carpedeam-tpu-torch\] ([a-z_]+?)(?:_\d+)?"
                         r"|## (\S+)): (\d+\.\d+)s", log, re.M):
        name = m.group(1) or m.group(2)
        out[name] = out.get(name, 0.0) + float(m.group(3))
    return dict(sorted(((k, round(v, 3)) for k, v in out.items()),
                       key=lambda kv: -kv[1])[:top])


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def correction_events(trace_path: str) -> int:
    """Device events of the correction kernels (gate and kernel) in a
    torch.profiler Chrome trace."""
    with open(trace_path) as fh:
        events = json.load(fh).get("traceEvents", [])
    return sum(1 for e in events if e.get("cat") == "kernel"
               and any(k in e.get("name", "")
                       for k in DEVICE_KERNELS["correction"]))


def check_world(reads, w15, rates, out_dir: str,
                device: str) -> tuple[str, str, bytes]:
    """Phase `world`: the CLI as one process and as a group of two ranks
    on the card.  Returns (15k reads FASTA, damage prefix, the 15k
    single-process FASTA) for phase `mesh`."""
    prefix = os.path.join(out_dir, "world_damage_")
    write_profiles(prefix, *rates)
    fa = os.path.join(out_dir, "world_120k.fa")
    write_fasta(reads, fa)
    # stage and sub-step seconds in the log, each rank writing its lines
    # whole (unbuffered)
    env = dict(os.environ, CARPEDEAM_SUBTIMING="1", PYTHONUNBUFFERED="1")
    one, s1, log1 = cli_assemble("world", fa,
                                 os.path.join(out_dir, "w1.fasta"), prefix,
                                 device, env=env)
    two, s2, log2 = cli_assemble("world", fa,
                                 os.path.join(out_dir, "w2.fasta"), prefix,
                                 device, ["--world", "2"], env=env)
    check(one == two, "the --world 2 FASTA differs from the single-process "
          "FASTA")
    check(one.count(b">") > 0, "the 120k CLI run wrote no contig")
    phase("world", f"120k CLI: one process {s1:.2f} s, --world 2 on one "
          f"card {s2:.2f} s (process start, read loading and build lookup "
          f"included); FASTA byte-identical ({len(one)} bytes)")
    phase("world", "one process, seconds by stage and sub-step: "
          + json.dumps(stage_split(log1)))
    phase("world", "--world 2, seconds summed over both ranks: "
          + json.dumps(stage_split(log2)))

    fa15 = os.path.join(out_dir, "world_15k.fa")
    write_fasta(w15, fa15)
    base15, s15, _ = cli_assemble("world", fa15,
                                  os.path.join(out_dir, "r1.fasta"), prefix,
                                  device)
    out = os.path.join(out_dir, "r2.fasta")
    coord = f"127.0.0.1:{free_port()}"
    threads = str(max(1, (os.cpu_count() or 2) // 2))
    cmd = cli_command(fa15, out, prefix, device)
    prof = [os.path.join(out_dir, f"rank{r}_profile") for r in range(2)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO, env=dict(os.environ, CARPEDEAM_RANK=str(r),
                           CARPEDEAM_WORLD="2", CARPEDEAM_COORD=coord,
                           CARPEDEAM_PROFILE_DIR=prof[r],
                           OMP_NUM_THREADS=threads)) for r in range(2)]
    try:
        outs = [p.communicate(timeout=400)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    secs = time.perf_counter() - t0
    for r, p in enumerate(procs):
        check(p.returncode == 0, f"rank {r} failed ({p.returncode}): "
              f"{outs[r][-2000:]}")
    with open(out, "rb") as fh:
        check(fh.read() == base15, "the two-rank FASTA (CARPEDEAM_COORD) "
              "differs from the single-process FASTA")
    for r in range(2):
        n_ev = correction_events(os.path.join(prof[r], "trace.json"))
        with open(os.path.join(prof[r], "launches.json")) as fh:
            launches = json.load(fh)
        check(n_ev > 0, f"rank {r}'s trace holds no device event of the "
              "correction kernel")
        check(launches["correction"] > 0, f"rank {r} launched no "
              "correction kernel")
        phase("world", f"rank {r}: {n_ev} correction kernel device events "
              f"in its trace; launches {json.dumps(launches)}")
    phase("world", f"15k CLI: one process {s15:.2f} s, two profiled ranks "
          f"(torch.distributed barrier at {coord}) {secs:.2f} s; FASTA "
          f"byte-identical ({len(base15)} bytes)")
    return fa15, prefix, base15


def check_mesh(dbs: dict, params, damage, fa15: str, prefix: str,
               base15: bytes, out_dir: str, device: str) -> None:
    """Phase `mesh`: the sharded stages over four shards on one device
    against the single-device stages and the host oracles, the CLI's
    --use-device mesh, and the device k-mer sort."""
    import numpy as np

    from carpedeam_tpu_torch.kmer.matcher import (
        BIT63, extract_selected_kmers_batched, kmermatcher,
        sort_kmer_entries_device)
    from carpedeam_tpu_torch.ops.correction_device import \
        correction_device_stage
    from carpedeam_tpu_torch.ops.rescore_device import rescorediagonal_device
    from carpedeam_tpu_torch.parallel.mesh import (correction_sharded,
                                                   make_mesh,
                                                   rescorediagonal_sharded)
    from carpedeam_tpu_torch.stages.correction import correction
    from carpedeam_tpu_torch.stages.rescorediagonal import rescorediagonal

    mesh = make_mesh([device] * 4)
    kps, scale = params.kmers_per_sequence, params.kmers_per_sequence_scale
    for name, (db, k, only_ext) in dbs.items():
        pref = kmermatcher(db, k, kps, scale, only_ext, params.hash_shift)
        seq_id = params.seq_id_thr if name == "read-phase" \
            else params.corr_contig_seq_id
        rargs = (seq_id, params.eval_thr, params.aln_len_thr)
        cargs = (damage, params.corr_reads_ry_seq_id, seq_id)
        runs = {}
        for label, rfn, cfn in (
                ("host", rescorediagonal, correction),
                ("one device", lambda *a: rescorediagonal_device(
                    *a, device=device), lambda *a: correction_device_stage(
                    *a, device=device)),
                ("4 shards", rescorediagonal_sharded(mesh),
                 correction_sharded(mesh))):
            t0 = time.perf_counter()
            aln = rfn(db, pref, *rargs)
            sync()
            t1 = time.perf_counter()
            corr = cfn(db, aln, *cargs)
            sync()
            runs[label] = (aln, corr, t1 - t0, time.perf_counter() - t1)
        host_text = runs["host"][0].to_text()
        for label in ("one device", "4 shards"):
            aln, corr, _, _ = runs[label]
            check(aln.to_text() == host_text, f"{label} rescore differs "
                  f"from the host oracle on the {name} DB")
            check(np.array_equal(corr.data, runs["host"][1].data),
                  f"{label} correction differs from the host oracle on the "
                  f"{name} DB")
        phase("mesh", f"{name} DB ({len(db)} sequences, {len(pref.qkey)} "
              f"pairs, {len(runs['host'][0])} alignments): AlnDB text and "
              "corrected bytes equal; seconds rescore / correction: "
              + "; ".join(f"{lb} {r[2]:.3f} / {r[3]:.3f}"
                          for lb, r in runs.items()))

    mesh15, s, _ = cli_assemble("mesh", fa15,
                                os.path.join(out_dir, "m.fasta"), prefix,
                                device, ["--use-device", "mesh"])
    check(mesh15 == base15, "the --use-device mesh FASTA differs from the "
          "default route's")
    phase("mesh", f"15k CLI --use-device mesh (a mesh of every visible "
          f"card) {s:.2f} s: FASTA byte-identical to the default route's")

    db, k, _ = dbs["read-phase"]
    ent = extract_selected_kmers_batched(db, k, kps, scale,
                                         params.hash_shift)
    t0 = time.perf_counter()
    host = np.lexsort((ent["pos"], ent["id"],
                       -ent["seq_len"].astype(np.int64),
                       ent["kmer"] | BIT63))
    host_s = time.perf_counter() - t0
    sort_kmer_entries_device(ent, device)
    dev_s = _best_seconds(lambda: sort_kmer_entries_device(ent, device), 3)
    check(np.array_equal(sort_kmer_entries_device(ent, device), host),
          "the device k-mer sort differs from np.lexsort")
    phase("mesh", f"sort_kmer_entries_device on {len(host)} entries: "
          f"permutation equal to np.lexsort's; {dev_s:.4f} s on the card "
          f"(host->device copies included, best of 3) against "
          f"{host_s:.4f} s for np.lexsort")


# ---- the deep long-contig configuration -----------------------------------

# BASELINE.json config 4 as tools/run_deep_config.py runs it: --unsafe
# long-contig mode, 12 iterations, and a split limit low enough that the
# host k-mer extraction runs in blocks
DEEP_FLAGS = ("--unsafe", "1", "--min-merge-seq-id", "0.97",
              "--num-iterations", "12", "--split-memory-limit", "128M")
# two runs at 500,000 reads (the JAX repo's scale for this
# configuration, DEEP_CONFIG_r05.json) take 1280 s on the H100's host,
# at 120,000 about 300 s; 35,000 is the smallest draw (in steps of 5,000)
# whose contigs still reach every ladder level (PERF.md section 4)
DEEP_READS = 35_000
DEEP_SPECIES = 10
# plane cells (rows x width) a plain version holds in one pass
PLAIN_CELLS = 1 << 26


def deep_params(use_device: str):
    """The deep configuration's Params, parsed from DEEP_FLAGS and
    `--use-device` by the flag parser of the port's CLI."""
    return default_params(use_device, DEEP_FLAGS)


def rescore_plain(code2, sym2, lens, pairs):
    """rescore_pairs_reference over chunks of pairs (each pair's word
    depends on that pair alone), PLAIN_CELLS window cells at a time."""
    import torch

    from carpedeam_tpu_torch.ops.rescore_cuda import rescore_pairs_reference
    step = max(1, PLAIN_CELLS // code2.shape[1])
    return torch.cat([rescore_pairs_reference(code2, sym2, lens,
                                              pairs[i:i + step])
                      for i in range(0, pairs.shape[0], step)])


def correction_plain(sym2, rec_rows, rscal, slot_qid, qscal, wtab, g: int,
                     rt: int):
    """correction_kernel_reference over chunks of blocks (a block reads
    its own records and slots alone), PLAIN_CELLS record cells at a
    time."""
    import torch

    from carpedeam_tpu_torch.ops.correction_cuda import \
        correction_kernel_reference
    nb = slot_qid.shape[0] // g
    step = max(1, PLAIN_CELLS // (rt * sym2.shape[1]))
    return torch.cat([correction_kernel_reference(
        sym2, rec_rows[b * rt:(b + step) * rt],
        rscal[b * rt:(b + step) * rt], slot_qid[b * g:(b + step) * g],
        qscal[b * g:(b + step) * g], wtab, g, rt)
        for b in range(0, nb, step)])


def ladder_level(L: int, levels) -> int:
    """The ladder level whose planes are `L` wide: the narrowest level
    that holds L (a level's planes are at most as wide as the level and
    wider than the level below it)."""
    return next(lvl for lvl in levels if L <= lvl)


class DeepTrace:
    """What one ancient_assemble run did per iteration and per ladder
    level, read by wrapping the pipeline's stage functions and the two
    kernel wrappers while it runs (the package's code is unchanged):

    - `longest`: (phase, longest sequence) after each iteration;
    - `levels`: (kernel, phase, level) -> launches and records on the
      card (rescore: pairs; correction: records with the use flag);
    - `host`: (stage, phase) -> records of each device stage on the card
      and on the host oracles, and of those on the host, the ones past
      the ladder's top level (correction's others are non-ACGT queries
      and stacks deeper than the record tile);
    - `largest`: (kernel, level) -> the cloned arguments of the level's
      call with the most rows, for levels above the first (with
      `keep_largest`);
    - `shapes`: (kernel, plane width) -> the largest call's rows (rescore
      pairs, correction blocks, window and consensus records), plane
      shape and phase; window and consensus `levels` are plane widths.

    With `subtimes`, the stages' sub-timers run (CARPEDEAM_SUBTIMING)
    and their lines go to the file `subtimes`.  `label` names the phase
    of the lines it prints."""

    def __init__(self, k_reads: int, subtimes: str | None = None,
                 label: str = "deep", keep_largest: bool = True):
        self.k_reads = k_reads
        self.subtimes_path = subtimes
        self.label = label
        self.keep_largest = keep_largest
        self.shapes: dict = {}
        self.phase = "read"
        self.longest: list = []
        self.levels: dict = {}
        self.host: dict = {}
        self.largest: dict = {}
        self.subtimes: dict = {}
        self._heavy = 0

    def _kmer(self, fn):
        def wrapper(seqdb, k, *args, **kw):
            self.phase = "read" if k == self.k_reads else "contig"
            return fn(seqdb, k, *args, **kw)
        return wrapper

    def _longest(self, fn):
        def wrapper(*args, **kw):
            out = fn(*args, **kw)
            self.longest.append((self.phase, int(out.lengths.max())
                                 if len(out) else 0))
            phase(self.label, f"iteration {len(self.longest)} ({self.phase} "
                  f"phase): {len(out)} sequences, longest "
                  f"{self.longest[-1][1]}")
            return out
        return wrapper

    def _stage(self, stage: str):
        """Records of one device stage on the card and on the host, from
        the coverage counts just before and just after each call."""
        from carpedeam_tpu_torch import utils
        from carpedeam_tpu_torch.ops.window_cuda import has_non_acgt_flags

        def make(fn):
            def wrapper(*args, **kw):
                before = dict(utils.DEVICE_COVERAGE.get(
                    stage, {"device": 0, "host": 0}))
                self._heavy = 0
                out = fn(*args, **kw)
                after = utils.DEVICE_COVERAGE[stage]
                d = self.host.setdefault((stage, self.phase), {
                    "device": 0, "host": 0, "past_ladder": 0})
                host = after["host"] - before["host"]
                d["device"] += after["device"] - before["device"]
                d["host"] += host
                other = 0
                if stage == "correction":
                    other = self._heavy + int(has_non_acgt_flags(
                        args[0]).sum())
                d["past_ladder"] += host - other
                return out
            return wrapper
        return make

    def _heavy_count(self, fn):
        def wrapper(*args, **kw):
            heavy = fn(*args, **kw)
            self._heavy += len(heavy)
            return heavy
        return wrapper

    def _kernel(self, kernel: str, levels, key: int, records, rows=None):
        """Counts of the wrapper `kernel` by ladder level (`levels`; None:
        by plane width); `rows(args)` is a call's size in `shapes`
        (default: argument `key`'s rows)."""
        def make(fn):
            def wrapper(*args, **kw):
                L = args[0].shape[1]
                lvl = ladder_level(L, levels) if levels else L
                d = self.levels.setdefault((kernel, self.phase, lvl),
                                           {"launches": 0, "records": 0})
                d["launches"] += 1
                d["records"] += records(args)
                n = rows(args) if rows else args[key].shape[0]
                sh = self.shapes.get((kernel, L))
                if sh is None or n > sh["rows"]:
                    self.shapes[(kernel, L)] = {
                        "rows": n, "plane": list(args[0].shape),
                        "phase": self.phase}
                best = self.largest.get((kernel, lvl))
                if self.keep_largest and levels and lvl > levels[0] and (
                        best is None
                        or args[key].shape[0] > best[key].shape[0]):
                    self.largest[(kernel, lvl)] = cloned(args)
                return fn(*args, **kw)
            return wrapper
        return make

    def by_kernel(self) -> dict:
        """`levels` as {kernel: {phase: {level: counts}}}."""
        out: dict = {}
        for (k, ph, lvl), d in sorted(self.levels.items()):
            out.setdefault(k, {}).setdefault(ph, {})[str(lvl)] = d
        return out

    def host_records(self) -> dict:
        """`host` as {"<stage> <phase>": counts}."""
        return {f"{st} {ph}": d for (st, ph), d in sorted(self.host.items())}

    @contextlib.contextmanager
    def installed(self):
        from carpedeam_tpu_torch import pipeline, utils
        from carpedeam_tpu_torch.ops import (correction_cuda, ext_cuda,
                                             rescore_cuda, window_cuda)
        from carpedeam_tpu_torch.ops.correction_cuda import CORR_LEN_LEVELS
        from carpedeam_tpu_torch.ops.rescore_cuda import LEN_LEVELS
        with contextlib.ExitStack() as stack:
            for name in ("kmermatcher", "kmermatcher_device"):
                stack.enter_context(patched(pipeline, name, self._kmer))
            for name in ("read_assembly", "contig_merge"):
                stack.enter_context(patched(pipeline, name, self._longest))
            stack.enter_context(patched(pipeline, "rescorediagonal_cuda",
                                        self._stage("rescorediagonal")))
            stack.enter_context(patched(pipeline, "correction_cuda",
                                        self._stage("correction")))
            stack.enter_context(patched(correction_cuda,
                                        "_run_correction_level",
                                        self._heavy_count))
            stack.enter_context(patched(
                rescore_cuda, "rescore_pairs",
                self._kernel("rescore_pairs", LEN_LEVELS, 3,
                             lambda a: a[3].shape[0])))
            stack.enter_context(patched(
                correction_cuda, "correction_kernel",
                self._kernel("correction", CORR_LEN_LEVELS, 1,
                             lambda a: int((a[2][:, 5] != 0).sum()),
                             rows=lambda a: a[3].shape[0] // a[6])))
            for mod, name in ((window_cuda, "window_identity"),
                              (ext_cuda, "consensus_likelihood")):
                stack.enter_context(patched(mod, name, self._kernel(
                    name, None, 1, lambda a: a[1].shape[0])))
            if self.subtimes_path:
                old = utils._SUBTIMING
                utils._SUBTIMING = True
                utils.SUBTIMES.clear()
                stack.callback(setattr, utils, "_SUBTIMING", old)
                fh = stack.enter_context(open(self.subtimes_path, "w"))
                stack.enter_context(contextlib.redirect_stderr(fh))
            yield self
            self.subtimes = dict(utils.SUBTIMES)


def subtimes_by_level(subtimes: dict,
                      prefixes=("rescore.", "corr.")) -> dict:
    """The sub-timers whose names start with one of `prefixes` (None:
    all), seconds summed over the run, correction's per-width ones
    (corr.<step>_L<width>) summed by the ladder level of the width
    (corr.<step>_lvl<level>)."""
    import re

    from carpedeam_tpu_torch.ops.correction_cuda import CORR_LEN_LEVELS
    out: dict[str, float] = {}
    for k, v in subtimes.items():
        m = re.fullmatch(r"(corr\.\w+)_L(\d+)", k)
        if m:
            lvl = ladder_level(int(m.group(2)), CORR_LEN_LEVELS)
            k = f"{m.group(1)}_lvl{lvl}"
        if prefixes is None or k.startswith(prefixes):
            out[k] = out.get(k, 0.0) + v
    return {k: round(v, 3) for k, v in sorted(out.items())}


def deep_rows(trace: DeepTrace) -> list:
    """Each kernel at each ladder level above the first that the run
    reached, on the level's largest call: equal to its plain version,
    with its times and bound."""
    import torch

    from carpedeam_tpu_torch.ops import correction_cuda, rescore_cuda
    rows = []
    for (kernel, lvl), args in sorted(trace.largest.items()):
        if kernel == "rescore_pairs":
            code2, sym2, lens, pairs = args
            out = rescore_cuda.rescore_pairs(*args)
            ref = rescore_plain(*args)
            cols, nbytes = _rescore_need(code2, lens, pairs, out)
            ops = 2.0 * cols
            case = f"level {lvl}: L={code2.shape[1]} P={pairs.shape[0]}"
            fn = (lambda a=args: rescore_cuda.rescore_pairs(*a))
            plain = (lambda a=args: rescore_plain(*a))
        else:
            out = correction_cuda.correction_kernel(*args)
            ref = correction_plain(*args)
            nbytes = _correction_bytes(*args, out)
            ops = _correction_ops(*args)
            sym2, _, _, slot_qid, _, _, g, rt = args
            case = (f"level {lvl}: L={sym2.shape[1]} "
                    f"blocks={slot_qid.numel() // g} G={g} R={rt}")
            fn = (lambda a=args: correction_cuda.correction_kernel(*a))
            plain = (lambda a=args: correction_plain(*a))
        sync()
        check(torch.equal(out, ref), f"{kernel} differs from its plain "
              f"version at the deep run's level {lvl}")
        rows.append({"name": kernel, "level": lvl, **kernel_row(
            "deep", kernel, case, fn, plain, nbytes, ops, 0)})
    return rows


def check_deep(n_reads: int, out_dir: str, device: str = "cuda") -> dict:
    """Phase `deep`: ancient_assemble in the deep configuration on a
    10-species mock community of `n_reads` reads, on the kernel route
    (`--use-device auto` on `device`) and the host route (`--use-device
    0`): equal FASTA; window and consensus launch on neither (--unsafe
    skips the batched extension scoring), rescore and correction on the
    kernel route in both phases; per ladder level the launches, the
    records on the card and those past the top level; each level above
    the first against its plain version, timed."""
    from carpedeam_tpu_torch import workload
    from carpedeam_tpu_torch.damage import DamageModel
    reads, rates = workload.generate(3, n_reads, coverage=20.0,
                                     species=DEEP_SPECIES)
    damage = DamageModel.from_rates(*rates)
    phase("deep", f"workload: {len(reads)} reads of {DEEP_SPECIES} "
          f"species, {reads.total_residues} residues; flags "
          + " ".join(DEEP_FLAGS))
    runs, traces = {}, {}
    for route, use in (("kernel", "auto"), ("host", "0")):
        params = deep_params(use)
        trace = DeepTrace(params.kmer_size_reads, os.path.join(
            out_dir, f"deep_{route}_subtimes.log"))
        run = run_assemble("deep", reads, params, damage, out_dir,
                           kmer_device=False, device=device,
                           hooks=trace.installed)
        sub = subtimes_by_level(trace.subtimes)
        phase("deep", f"{route} route: sub-timers " + json.dumps(sub))
        phase("deep", f"{route} route: longest sequence after each "
              "iteration " + json.dumps(trace.longest))
        runs[route], traces[route] = run, trace
    kernel, host = runs["kernel"], runs["host"]
    check(kernel["fasta"] == host["fasta"], "the deep configuration's FASTA "
          "differs between the kernel route and the host route")
    check(traces["kernel"].longest == traces["host"].longest,
          "the two routes grew different sequences")
    check(not any(host["launches"].values()),
          f"the host route launched kernels: {host['launches']}")
    for k in ("window_identity", "consensus_likelihood"):
        check(kernel["launches"][k] == 0, f"{k} launched under --unsafe")
    tr = traces["kernel"]
    levels = tr.by_kernel()
    for k in ("rescore_pairs", "correction"):
        for ph in ("read", "contig"):
            check(sum(d["launches"] for d in
                      levels.get(k, {}).get(ph, {}).values()) > 0,
                  f"{k} did not launch in the {ph} phase")
        # the wrappers launch nothing on the CPU (their plain versions)
        check(device == "cpu" or sum(
            d["launches"] for per in levels[k].values()
            for d in per.values()) == kernel["launches"][k],
            f"{k}: per-level launches do not add up to its count")
    reached = {k: sorted({int(lvl) for per in v.values() for lvl in per})
               for k, v in levels.items()}
    # every ladder level, as the 500k run reached them (the CPU rehearsal
    # runs too few reads)
    from carpedeam_tpu_torch.ops.correction_cuda import CORR_LEN_LEVELS
    from carpedeam_tpu_torch.ops.rescore_cuda import LEN_LEVELS
    check(device == "cpu" or (
        reached.get("rescore_pairs") == list(LEN_LEVELS)
        and reached.get("correction") == list(CORR_LEN_LEVELS)),
        f"the deep run did not reach every ladder level: {reached}")
    host_rest = tr.host_records()
    phase("deep", "ladder levels reached " + json.dumps(reached))
    phase("deep", "per level (launches, records on the card) "
          + json.dumps(levels))
    phase("deep", "records by stage and phase (card, host, past the top "
          "level) " + json.dumps(host_rest))
    phase("deep", f"FASTA byte-identical on both routes "
          f"({len(kernel['fasta'])} bytes, {kernel['fasta'].count(b'>')} "
          f"contigs); walls {kernel['wall']:.2f} s (kernel route), "
          f"{host['wall']:.2f} s (host route)")
    rows = deep_rows(tr) if device != "cpu" else []
    return {"reads": n_reads, "species": DEEP_SPECIES,
            "flags": " ".join(DEEP_FLAGS),
            "wall_s": {"kernel": kernel["wall"], "host": host["wall"]},
            "stages_s": {"kernel": kernel["stages"], "host": host["stages"]},
            "longest": tr.longest, "levels_reached": reached,
            "levels": levels, "host_records": host_rest,
            "launches": kernel["launches"],
            "coverage": kernel["coverage"], "kernel_rows": rows}


# ---- the default pipeline at a real size ---------------------------------

# BASELINE.json config 3: a 10-species mock ancient community, default
# flags; `--scale N` draws N reads of it
SCALE_SEED = 4
SCALE_SPECIES = 10
# sha256 of the JAX package's FASTA on those reads, by N: its
# ancient_assemble with --use-device 0 and default flags under
# JAX_PLATFORMS=cpu, handed the port's SeqDB (PERF.md section 4)
JAX_FASTA_SHA256 = {
    1_000_000:
        "fa9fe4f5e8815acc8a403a1f4507e16d33f88297f8bfd17569ca2d6f696b6d1b",
}
# route -> (--use-device, CARPEDEAM_KMER_DEVICE); the device kmermatcher
# rides along up to SCALE_KMER_READS
SCALE_ROUTES = {"kernel": ("auto", False), "host": ("0", False),
                "kmer_device": ("auto", True)}
SCALE_KMER_READS = 1_000_000
SCALE_KERNELS = ("rescore_pairs", "correction", "window_identity",
                 "consensus_likelihood")
SCALE_STAGES = ("rescorediagonal", "correction", "extension_scoring")


def default_params(use_device: str, flags=()):
    """Params parsed from `flags` and `--use-device` by the flag parser of
    the port's CLI (no flags: the default pipeline)."""
    import argparse

    from carpedeam_tpu_torch.params import add_flags, params_from_args
    ap = argparse.ArgumentParser()
    add_flags(ap)
    return params_from_args(ap.parse_args(
        [*flags, "--use-device", use_device]))


def scale_reads(n_reads: int):
    from carpedeam_tpu_torch import workload
    return workload.generate(SCALE_SEED, n_reads, coverage=20.0,
                             species=SCALE_SPECIES)


# BASELINE.json config 2: heavy-damage short reads (gargammel E. coli,
# about 35 bp mean, about 0.3 C->T) with 5 + 9 iterations; a drawn genome
# stands in for gargammel's, which is not in the repo
SHORT_FLAGS = ("--num-iter-reads-only", "5", "--num-iterations", "14")
SHORT_READS = 120_000
# terminal C->T and G->A rates 0.30 falling by 0.8 a position over 15
# positions, then the interior rate 0.01 (tools/make_workload.py's rate
# past a profile's rows)
SHORT_RATES = tuple(0.30 * 0.8 ** i for i in range(15)) + (0.01,)


def short_reads(seed: int, n_reads: int):
    """Config 2's reads: lengths 25-120 with mean 35, SHORT_RATES at both
    ends."""
    from carpedeam_tpu_torch import workload
    return workload.generate(seed, n_reads, coverage=20.0, min_len=25,
                             mean_len=35.0, ct5=SHORT_RATES,
                             ga3=SHORT_RATES)


def scale_route(n_reads: int, route: str, out_dir: str,
                device: str = "cuda") -> int:
    """One route of `--scale`, run in a child process of its own so that
    its peak host RSS is its own: ancient_assemble on the config-3 reads,
    traced per kernel and ladder level; writes scale_<route>.json."""
    import hashlib
    import resource

    import torch

    from carpedeam_tpu_torch import utils
    from carpedeam_tpu_torch.damage import DamageModel
    utils.set_verbosity(2)
    use, kmer_device = SCALE_ROUTES[route]
    reads, rates = scale_reads(n_reads)
    damage = DamageModel.from_rates(*rates)
    params = default_params(use)
    trace = DeepTrace(params.kmer_size_reads, os.path.join(
        out_dir, f"scale_{route}_subtimes.log"), label="scale-run",
        keep_largest=False)
    run = run_assemble(f"scale_{route}", reads, params, damage, out_dir,
                       kmer_device=kmer_device, device=device,
                       hooks=trace.installed)
    fasta = run.pop("fasta")
    lens = [int(h.split(b"len:")[1].split()[0])
            for h in fasta.split(b"\n") if h.startswith(b">")]
    out = {"route": route, "use_device": use, "kmer_device": kmer_device,
           "reads": len(reads), "residues": int(reads.total_residues),
           **run, "levels": trace.by_kernel(),
           "shapes": {f"{k} L={w}": v
                      for (k, w), v in sorted(trace.shapes.items())},
           "host_records": trace.host_records(),
           "longest": trace.longest,
           "subtimes": subtimes_by_level(trace.subtimes, prefixes=None),
           "contigs": len(lens), "longest_contig": max(lens),
           "fasta_bytes": len(fasta),
           "fasta_sha256": hashlib.sha256(fasta).hexdigest(),
           "peak_rss_gib": resource.getrusage(
               resource.RUSAGE_SELF).ru_maxrss / 2 ** 20,
           "max_device_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                             if torch.cuda.is_initialized() else 0.0)}
    with open(os.path.join(out_dir, f"scale_{route}.json"), "w") as fh:
        json.dump(out, fh)
    return 0


def check_scale(n_reads: int, out_dir: str, device: str = "cuda") -> dict:
    """`--scale N`: the default pipeline on N reads of the config-3
    community on the kernel route and the host route (and with the device
    kmermatcher up to SCALE_KMER_READS), each in a child process: equal
    FASTA, equal to the JAX package's where its hash is recorded, all four
    kernels launched on the kernel route and none on the host route,
    every device stage with records on the card.  On the CPU (a rehearsal)
    the kernel route runs the plain versions and launches nothing."""
    phase("scale-run", f"workload: {n_reads} reads of {SCALE_SPECIES} "
          f"species (seed {SCALE_SEED}), default flags")
    routes = [r for r in SCALE_ROUTES
              if r != "kmer_device" or n_reads <= SCALE_KMER_READS]
    res = {}
    for route in routes:
        t0 = time.perf_counter()
        rc = subprocess.run(
            [sys.executable, "-c", "import sys, chip_smoke; sys.exit("
             f"chip_smoke.scale_route({n_reads}, {route!r}, {out_dir!r}, "
             f"{device!r}))"],
            cwd=REPO, timeout=3600).returncode
        check(rc == 0, f"the {route} route exited with {rc}")
        with open(os.path.join(out_dir, f"scale_{route}.json")) as fh:
            r = json.load(fh)
        res[route] = r
        phase("scale-run", f"{route} route ({r['residues']} residues): "
              f"{r['contigs']} contigs, longest "
              f"{r['longest_contig']}, wall {r['wall']:.2f} s (child "
              f"{time.perf_counter() - t0:.2f} s); peak host RSS "
              f"{r['peak_rss_gib']:.3f} GiB, peak device memory "
              f"{r['max_device_gib']:.3f} GiB; sha256 {r['fasta_sha256']}")
        for key in ("stages", "subtimes", "levels", "shapes", "coverage",
                    "host_records", "longest"):
            phase("scale-run", f"{route} route: {key} " + json.dumps(
                {k: round(v, 3) for k, v in r[key].items()}
                if key in ("stages", "subtimes") else r[key]))
    kern, host = res["kernel"], res["host"]
    check(kern["fasta_sha256"] == host["fasta_sha256"],
          "the kernel route's FASTA differs from the host route's")
    ref = JAX_FASTA_SHA256.get(n_reads)
    if ref is not None:
        check(kern["fasta_sha256"] == ref, "the FASTA differs from the JAX "
              "package's")
    for k in SCALE_KERNELS:
        check(device == "cpu" or kern["launches"][k] > 0,
              f"kernel {k} did not launch on the kernel route")
    check(not any(host["launches"].values()),
          f"the host route launched kernels: {host['launches']}")
    for st in SCALE_STAGES:
        d = kern["coverage"].get(st)
        check(d is not None and d["device"] > 0,
              f"stage {st} ran no records on the card")
    if "kmer_device" in res:
        kd = res["kmer_device"]
        check(kd["fasta_sha256"] == kern["fasta_sha256"],
              "the CARPEDEAM_KMER_DEVICE=1 FASTA differs")
        km = kd["coverage"].get("kmermatcher")
        check(km is not None and km["host"] == 0 and km["device"] > 0,
              f"kmermatcher calls not all on the card: {km}")
    phase("scale-run", f"FASTA byte-identical on {len(res)} routes "
          f"({kern['fasta_bytes']} bytes, {kern['contigs']} contigs); "
          + (f"equal to the JAX package's ({ref})" if ref else
             "no JAX hash recorded at this size: held route against route"))
    return {"reads": n_reads, "seed": SCALE_SEED,
            "species": SCALE_SPECIES, "jax_sha256": ref, "routes": res}


def check_short(n_reads: int, out_dir: str, device: str = "cuda") -> dict:
    """Phase `short`: config 2 (SHORT_FLAGS on short_reads(5, n_reads))
    on the kernel route and the host route: equal FASTA and equal
    sequences after every iteration; all four kernels launched on the
    kernel route, none on the host route, every device stage with records
    on the card."""
    from carpedeam_tpu_torch.damage import DamageModel
    reads, rates = short_reads(5, n_reads)
    damage = DamageModel.from_rates(*rates)
    phase("short", f"workload: {len(reads)} reads, {reads.total_residues} "
          f"residues, mean length {reads.lengths.mean():.2f}; flags "
          + " ".join(SHORT_FLAGS))
    runs, longest = {}, {}
    for route, use in (("kernel", "auto"), ("host", "0")):
        params = default_params(use, SHORT_FLAGS)
        trace = DeepTrace(params.kmer_size_reads, label="short",
                          keep_largest=False)
        runs[route] = run_assemble("short", reads, params, damage, out_dir,
                                   kmer_device=False, device=device,
                                   hooks=trace.installed)
        longest[route] = trace.longest
    kern, host = runs["kernel"], runs["host"]
    check(len(longest["kernel"]) == 14, "config 2 did not run 14 iterations")
    check(longest["kernel"] == longest["host"],
          "the two routes grew different sequences")
    check(kern["fasta"] == host["fasta"], "config 2's FASTA differs between "
          "the kernel route and the host route")
    check(not any(host["launches"].values()),
          f"the host route launched kernels: {host['launches']}")
    for k in SCALE_KERNELS:
        check(device == "cpu" or kern["launches"][k] > 0,
              f"kernel {k} did not launch on config 2's kernel route")
    for st in SCALE_STAGES:
        d = kern["coverage"].get(st)
        check(d is not None and d["device"] > 0,
              f"stage {st} ran no records on the card")
    phase("short", f"FASTA byte-identical on both routes "
          f"({len(kern['fasta'])} bytes, {kern['fasta'].count(b'>')} "
          f"contigs); longest sequence after each iteration "
          + json.dumps(longest["kernel"]))
    return {"reads": n_reads, "flags": " ".join(SHORT_FLAGS),
            "wall_s": {r: v["wall"] for r, v in runs.items()},
            "stages_s": {r: v["stages"] for r, v in runs.items()},
            "launches": kern["launches"], "coverage": kern["coverage"],
            "contigs": kern["fasta"].count(b">"), "longest": longest["kernel"]}


# ---- phase scale: the kernels at the 5M run's largest call shapes ---------

# the largest call of each kernel at the widths the 5M run gave it
# (`--scale 5000000`, PERF.md section 6): (kernel, plane width, rescore
# pairs / correction blocks / window and consensus records, plane rows
# 2N); rescore at 128 and correction at 512 are the read and contig
# phases' first iterations
SCALE_CALLS = (("rescore_pairs", 128, 14_278_641, 10_000_000),
               ("rescore_pairs", 512, 6_825_866, 10_000_000),
               ("correction", 512, 145_810, 10_000_000),
               ("window_identity", 128, 2_354_590, 10_000_000),
               ("consensus_likelihood", 128, 1_839_824, 10_000_000))
# what the plane derivation may allocate above its inputs, past its output
# (PERF.md section 6): assemble_planes took 0.29 GiB at the 5M contig
# phase's (10M, 512) plane, derive_corrected_planes 0.99 GiB at (10M, 128),
# 0.60 GiB of it the corrected forward plane
SCALE_DERIVE_SCRATCH = 3 << 29


def scale_plane(gen, n: int, L: int, hi: int):
    """(forward symbol plane, lengths, offsets): n rows of lengths 25..hi
    (capped at L) read at random offsets of a random genome at coverage
    20 with 1% random bases, and each row's genome offset (two rows'
    offsets give their alignment)."""
    import torch

    from carpedeam_tpu_torch.ops.planes import row_chunks
    dev = gen.device
    lens = torch.randint(25, hi + 1, (n,), generator=gen, device=dev,
                         dtype=torch.int32).clamp(max=L)
    glen = max(int(lens.sum().item()) // 20, 4 * L)
    genome = torch.randint(0, 4, (glen + L,), generator=gen, device=dev,
                           dtype=torch.uint8)
    off = torch.randint(0, glen, (n,), generator=gen, device=dev)
    acgt = torch.tensor(list(b"ACGT"), dtype=torch.uint8, device=dev)
    pos = torch.arange(L, device=dev)
    sym = torch.empty((n, L), dtype=torch.uint8, device=dev)
    for a, b in row_chunks(n, L):
        code = genome[off[a:b, None] + pos[None, :]]
        noise = torch.randint(0, 4, code.shape, generator=gen, device=dev,
                              dtype=torch.uint8)
        hit = torch.rand(code.shape, generator=gen, device=dev) < 0.01
        row = acgt[torch.where(hit, noise, code).long()]
        sym[a:b] = torch.where(pos[None, :] < lens[a:b, None], row, 0)
    return sym, lens, off


def _neighbours(gen, off, q):
    """For each query row in q, one of the eight rows after it by genome
    offset (an overlapping row)."""
    import torch
    n = off.shape[0]
    order = torch.argsort(off)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=off.device)
    step = torch.randint(1, 9, q.shape, generator=gen, device=off.device)
    return order[(rank[q] + step).clamp(max=n - 1)]


def scale_inputs(gen, kernel: str, rows: int, planes, off, tables):
    """Arguments of `kernel` with `rows` pairs, blocks or records of
    overlapping rows of `planes` (offsets `off`), drawn from `gen`;
    `tables`: the correction and consensus weight tables."""
    import torch

    from carpedeam_tpu_torch.ops.correction_cuda import _tiles_for
    n = off.shape[0]
    dev = off.device
    lens = planes["len"].to(torch.int64)

    def i32(*cols):
        return torch.stack(cols, dim=1).to(torch.int32).contiguous()
    if kernel == "correction":
        g, rt = _tiles_for(planes["sym"].shape[1])
        slot_q = torch.randint(0, n, (rows * g,), generator=gen, device=dev)
        q = slot_q.repeat_interleave(rt // g)      # rt / g records a slot
    else:
        q = torch.randint(0, n, (rows,), generator=gen, device=dev)
    t = _neighbours(gen, off, q)
    qstart = (off[t] - off[q]).clamp(min=0)
    tstart = (off[q] - off[t]).clamp(min=0)
    alen = torch.minimum(lens[q] - qstart, lens[t] - tstart).clamp(min=0)
    zero = torch.zeros_like(q)
    if kernel == "rescore_pairs":
        rev = torch.rand(rows, generator=gen, device=dev) < 0.5
        qf = q | torch.where(rev, -(1 << 31), 0)
        return (planes["code"], planes["sym"], planes["len"],
                i32(qf, t, (off[t] - off[q]) % 65536))
    if kernel == "correction":
        use = (alen > 0) & (torch.rand(q.shape, generator=gen, device=dev)
                            < 0.9)
        slot = torch.arange(q.shape[0], device=dev) % rt // (rt // g)
        rscal = i32(qstart, tstart, alen, lens[t], alen * 9 // 10,
                    use.long(), torch.where(use, slot, g), zero)
        was_ext = torch.rand(rows * g, generator=gen, device=dev) < 0.1
        qscal = i32(lens[slot_q], was_ext.long(),
                    *([torch.zeros_like(slot_q)] * 6))
        return (planes["sym"], t.to(torch.int32), rscal,
                slot_q.to(torch.int32), qscal, tables["wtab"], g, rt)
    if kernel == "window_identity":
        return (planes["sym"], q.to(torch.int32), t.to(torch.int32),
                i32(qstart, tstart, alen, zero))
    return (planes["sym"], q.to(torch.int32), t.to(torch.int32),
            i32(off[t] - off[q], lens[q], lens[t], zero, lens[t], zero,
                zero, zero), tables["logm"])


def records_plain(reference, sym2, *args):
    """`reference` (window_identity_reference or
    consensus_likelihood_reference) over chunks of records (each record's
    row reads its own two plane rows alone), PLAIN_CELLS cells a pass;
    the arguments past the three per-record ones pass whole."""
    import torch
    per, rest = args[:3], args[3:]
    step = max(1, PLAIN_CELLS // sym2.shape[1])
    return torch.cat([reference(sym2, *(a[i:i + step] for a in per), *rest)
                      for i in range(0, per[0].shape[0], step)])


def correction_ops(args) -> float:
    """_correction_ops over chunks of blocks (a block's cells and classes
    are its own)."""
    sym2, rec_rows, rscal, slot_qid, qscal, wtab, g, rt = args
    nb = slot_qid.shape[0] // g
    step = max(1, PLAIN_CELLS // (rt * sym2.shape[1]))
    return sum(_correction_ops(
        sym2, rec_rows[b * rt:(b + step) * rt],
        rscal[b * rt:(b + step) * rt], slot_qid[b * g:(b + step) * g],
        qscal[b * g:(b + step) * g], wtab, g, rt)
        for b in range(0, nb, step))


def check_scale_derive(gen, sym, lens) -> dict:
    """The chunked plane derivation (assemble_planes) at the 5M contig
    phase's shared-plane shape and the corrected-plane derivation
    (derive_corrected_planes) at that row count, 128 wide: peak device
    memory above the inputs within the output and SCALE_DERIVE_SCRATCH,
    1,000 rows of each equal to the CPU's derivation of those rows."""
    import torch

    from carpedeam_tpu_torch.ops.correction_cuda import \
        derive_corrected_planes
    from carpedeam_tpu_torch.ops.planes import assemble_planes
    n, L = sym.shape
    out = {}
    on_card = sym.device.type == "cuda"
    idx = torch.randperm(n, generator=gen, device=gen.device)[:1000]
    for name in ("assemble_planes", "derive_corrected_planes"):
        if name == "assemble_planes":
            args = (sym, lens)
            fn = assemble_planes
        else:
            lens = lens.clamp(max=128)
            planes = assemble_planes(sym[:, :128].contiguous(), lens)
            packed = torch.randint(0, 256, ((n + 3) // 4, 128),
                                   generator=gen, device=gen.device,
                                   dtype=torch.uint8)
            src = torch.randperm(packed.shape[0] * 4, generator=gen,
                                 device=gen.device)[:n].to(torch.int32)
            src[::7] = -1
            args = (planes["sym"], lens, packed, src)
            fn = derive_corrected_planes
        sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        got = fn(*args)
        sync()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base if on_card else 0
        made = sum(v.numel() * v.element_size() for v in got.values())
        check(peak <= made + SCALE_DERIVE_SCRATCH, f"{name} took {peak} "
              f"bytes above its inputs, over its {made}-byte output and "
              f"{SCALE_DERIVE_SCRATCH} bytes of scratch")
        if name == "assemble_planes":
            cpu = assemble_planes(sym[idx].cpu(), lens[idx].cpu())
        else:
            cpu = derive_corrected_planes(planes["sym"][idx].cpu(),
                                          lens[idx].cpu(), packed.cpu(),
                                          src[idx].cpu())
        # rows idx, forward and reverse, equal the CPU's derivation of
        # those rows alone
        k = idx.shape[0]
        for plane in ("sym", "code"):
            for part, rows in ((slice(0, k), idx),
                               (slice(k, 2 * k), idx + n)):
                check(torch.equal(got[plane][rows].cpu(), cpu[plane][part]),
                      f"{name}: the derived {plane} plane differs from the "
                      f"CPU's")
        shape = list(got["sym"].shape)
        phase("scale", f"{name} at {shape}: {secs:.3f} s, peak device "
              f"memory {peak / 2 ** 30:.3f} GiB above its inputs "
              f"(output {made / 2 ** 30:.3f} GiB); 1000 rows equal to the "
              f"CPU's")
        out[name] = {"shape": shape, "s": secs, "peak_gib": peak / 2 ** 30,
                     "output_gib": made / 2 ** 30}
        del got
    return out


def check_scale_kernels(damage, device: str = "cuda",
                        calls=SCALE_CALLS) -> dict:
    """Phase `scale`: the plane derivation at the 5M contig phase's shape
    (check_scale_derive), then each kernel at its largest call shape of
    the 5M run (SCALE_CALLS) on synthetic overlapping rows from a seeded
    generator, bit for bit against its plain version in chunks, with its
    times and bound.  On the CPU (a rehearsal at small `calls`) the
    wrappers run their plain versions and nothing is timed."""
    import numpy as np
    import torch

    from carpedeam_tpu_torch.convert import consensus_logm
    from carpedeam_tpu_torch.ops import correction_cuda
    from carpedeam_tpu_torch.ops.planes import assemble_planes
    gen = torch.Generator(device=device).manual_seed(5_000_000)
    tables = {"wtab": torch.from_numpy(correction_cuda.correction_wtab(
                  damage)).to(device),
              "logm": torch.from_numpy(np.ascontiguousarray(
                  consensus_logm(damage), dtype=np.float32)).to(device)}
    derive, rows = None, []
    for width in sorted({c[1] for c in calls}, reverse=True):
        n = max(c[3] for c in calls if c[1] == width) // 2
        sym, lens, off = scale_plane(gen, n, width, 120 if width == 128
                                     else width)
        if width == 512:
            derive = check_scale_derive(gen, sym, lens)
        planes = assemble_planes(sym, lens)
        del sym
        for kernel, w, n_rows, _ in calls:
            if w != width:
                continue
            args = scale_inputs(gen, kernel, n_rows, planes, off, tables)
            rows.append(scale_row(kernel, args))
            del args
        del planes, off
        if device != "cpu":
            torch.cuda.empty_cache()
    return {"derive": derive, "kernel_rows": rows}


def scale_row(kernel: str, args) -> dict:
    """One kernel call of phase scale against its plain version in
    chunks, with its times and bound."""
    import torch

    from carpedeam_tpu_torch.ops import (correction_cuda, ext_cuda,
                                         rescore_cuda, window_cuda)
    if kernel == "rescore_pairs":
        fn, plain = rescore_cuda.rescore_pairs, rescore_plain
    elif kernel == "correction":
        fn, plain = correction_cuda.correction_kernel, correction_plain
    elif kernel == "window_identity":
        fn = window_cuda.window_identity
        plain = (lambda *a: records_plain(
            window_cuda.window_identity_reference, *a))
    else:
        fn = ext_cuda.consensus_likelihood
        plain = (lambda *a: records_plain(
            ext_cuda.consensus_likelihood_reference, *a))
    out = fn(*args)
    ref = plain(*args)
    sync()
    check(torch.equal(out, ref), f"{kernel} differs from its plain version "
          f"at the 5M run's shape")
    L = args[0].shape[1]
    if kernel == "rescore_pairs":
        cols, nbytes = _rescore_need(args[0], args[2], args[3], out)
        ops, case = 2.0 * cols, f"L={L} P={args[3].shape[0]}"
    elif kernel == "correction":
        nbytes = _correction_bytes(*args, out)
        ops = correction_ops(args)
        case = (f"L={L} blocks={args[3].shape[0] // args[6]} "
                f"G={args[6]} R={args[7]}")
    else:
        need = (_window_need if kernel == "window_identity"
                else _consensus_need)
        nbytes, ops = need(args, out)
        case = f"L={L} n={args[1].shape[0]}"
    if out.device.type == "cpu":
        return {"name": kernel, "case": case, "bytes": nbytes, "ops": ops}
    row = kernel_row("scale", kernel, case, lambda: fn(*args),
                     lambda: plain(*args), nbytes, ops, 0, plain_reps=1)
    return {"name": kernel, **row}


def main(argv: list[str]) -> int:
    import torch
    alone = argv[0] if argv else None
    if argv and not (alone in ("--deep", "--scale") and len(argv) == 2
                     and argv[1].isdigit()):
        print("usage: chip_smoke.py [--deep N | --scale N]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    # ---- device --------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else "nvidia-smi: " + smi.stderr.strip()
    device_name = torch.cuda.get_device_name(0)
    phase("device", f"{device_name}, {torch.cuda.device_count()} device(s), "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi_line, flush=True)

    # ---- build ---------------------------------------------------------
    from carpedeam_tpu_torch import _build, native
    kb = _build.build_kernels()
    phase("build", f"CUDA kernels (one nvcc call) {kb.seconds:.2f} s "
          f"{'(cached)' if kb.cached else ''} -> {kb.path}")
    for line in kb.log.splitlines():
        if "entry function" in line:
            print(f"    ptxas: {line.split(chr(39))[1]}", flush=True)
        elif "registers" in line or "spill" in line:
            print(f"    ptxas:   {line.strip()}", flush=True)
    nb = native.build()
    phase("build", f"host C++ library {nb.seconds:.2f} s "
          f"{'(cached)' if nb.cached else ''} -> {nb.path}")
    out_dir = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    if alone:
        from carpedeam_tpu_torch import utils
        utils.set_verbosity(2)
        name = alone[2:]
        got = (check_deep if name == "deep" else check_scale)(int(argv[1]),
                                                              out_dir)
        phase("done", f"phase {name} passed in "
              f"{time.perf_counter() - T0:.1f} s")
        print(smi_line, flush=True)
        print(json.dumps({name: got}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": device_name,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    # ---- kernels -------------------------------------------------------
    import numpy as np

    from carpedeam_tpu_torch import utils, workload
    from carpedeam_tpu_torch.damage import DamageModel
    from carpedeam_tpu_torch.params import Params
    utils.set_verbosity(2)
    reads, rates = workload.generate(1, 120_000, coverage=20.0)
    sub5p, sub3p = rates
    damage = DamageModel.from_rates(sub5p, sub3p)
    params = Params()
    phase("kernels", f"workload: {len(reads)} reads, "
          f"{reads.total_residues} residues")
    check_edges(damage, "cuda")
    check_kmer_edges("cuda")
    rows = check_kernels(damage, params, "cuda", reads)

    # ---- assemble ------------------------------------------------------
    from carpedeam_tpu_torch import pipeline
    from carpedeam_tpu_torch.pipeline import nuclassemble
    km_calls: list = []
    with capture(pipeline, "kmermatcher", km_calls):
        run = run_assemble("assemble", reads, params, damage, out_dir,
                           kmer_device=False)
    launches = run["launches"]
    for k in KMER_KERNELS:
        check(launches[k] == 0, f"kernel {k} launched on the host-kmer path")
    for k, v in launches.items():
        check(v > 0 or k in KMER_KERNELS,
              f"kernel {k} was not launched by the main path")
    for stage in ("rescorediagonal", "correction", "extension_scoring"):
        d = run["coverage"].get(stage)
        check(d is not None and d["device"] > 0,
              f"stage {stage} ran no records on the card")

    # ---- kmer ----------------------------------------------------------
    # the first read-phase and the first contig-phase SeqDB of the run
    dbs = {}
    for db, k, _, _, only_ext, *_ in km_calls:
        dbs.setdefault("read-phase" if k == params.kmer_size_reads
                       else "contig-phase", (db, k, only_ext))
    check(len(dbs) == 2, "the run gave no read- and contig-phase SeqDBs")
    kmer_rows = check_kmer(dbs, params, "cuda")
    rows.update({k: v for k, v in kmer_rows.items() if k in KMER_KERNELS})
    krun = run_assemble("assemble", reads, params, damage, out_dir,
                        kmer_device=True)
    check(krun["fasta"] == run["fasta"], "the CARPEDEAM_KMER_DEVICE=1 FASTA "
          "differs from the default run's")
    km = krun["coverage"].get("kmermatcher")
    check(km is not None and km["host"] == 0 and km["device"] > 0,
          f"kmermatcher calls not all on the card: {km}")
    for k in KMER_KERNELS:
        check(krun["launches"][k] > 0,
              f"kernel {k} was not launched by the device-kmer path")
        launches[k] = krun["launches"][k]
    secs = (krun["stages"]["kmermatcher"], run["stages"]["kmermatcher"])
    phase("assemble", "CARPEDEAM_KMER_DEVICE=1 FASTA byte-identical to the "
          f"default run's; kmermatcher stage {secs[0]:.3f} s on the card "
          f"against {secs[1]:.3f} s on the host; {km['device']} of "
          f"{km['total']} calls on the card")

    # ---- repeat --------------------------------------------------------
    sl = reads.select(np.arange(15_000))
    p2 = params.copy(num_iterations=2, num_iterations_reads=1,
                     min_contig_len=0)
    fastas = []
    for i, dev in enumerate(("cuda", "cuda", "cpu")):
        t0 = time.perf_counter()
        if i == 1:
            # the profiler slows the host side many times over, so the
            # busy share is taken against the first, unprofiled run
            with device_profile() as prof:
                res, _, _ = nuclassemble(sl, p2, damage, device=dev)
            phase("repeat", f"profiled cuda run: device busy "
                  f"{prof['device_ms']:.3f} ms = "
                  f"{100 * prof['device_ms'] / 1e3 / wall0:.3f}% of the "
                  f"unprofiled run's {wall0:.3f} s (profiled wall "
                  f"{prof['wall_s']:.3f} s); top device ops "
                  + json.dumps(prof["top"]))
        else:
            res, _, _ = nuclassemble(sl, p2, damage, device=dev)
            if dev == "cuda":
                torch.cuda.synchronize()
        if i == 0:
            wall0 = time.perf_counter() - t0
        res.headers = [f"{i} len:{int(res.lengths[i])}"
                       for i in range(len(res))]
        path = os.path.join(out_dir, f"repeat_{len(fastas)}_{dev}.fasta")
        res.to_fasta(path)
        with open(path, "rb") as fh:
            fastas.append(fh.read())
        phase("repeat", f"{dev}: {len(res)} sequences, "
              f"{len(fastas[-1])} FASTA bytes")
    check(fastas[0] == fastas[1], "two CUDA runs wrote different FASTA")
    check(fastas[0] == fastas[2], "CUDA and CPU runs wrote different FASTA")
    phase("repeat", "FASTA byte-identical across the two CUDA runs and the "
          "CPU run")

    # ---- use_device_1 --------------------------------------------------
    # a 15,000-read workload at the same coverage (the slice above covers
    # its genome 2.5 times and assembles no contig of the minimum length)
    w15, _ = workload.generate(2, 15_000, coverage=20.0)
    base = run_assemble("use_device_1", w15, params, damage, out_dir,
                        kmer_device=False)
    one = run_assemble("use_device_1", w15, params.copy(use_device="1"),
                       damage, out_dir, kmer_device=False)
    check(one["fasta"] == base["fasta"], "the --use-device 1 FASTA differs "
          "from the default CUDA run's")
    phase("use_device_1", f"--use-device 1 FASTA byte-identical to the "
          f"default CUDA run's ({len(base['fasta'])} bytes)")

    # ---- paired --------------------------------------------------------
    check_paired(w15, rates, out_dir)

    # ---- stages, mlp ---------------------------------------------------
    stages = check_stages(reads, w15, rates, out_dir)
    mlp = check_mlp(out_dir)

    # ---- world, mesh ---------------------------------------------------
    fa15, prefix, base15 = check_world(reads, w15, rates, out_dir, "cuda")
    check_mesh(dbs, params, damage, fa15, prefix, base15, out_dir, "cuda")

    # ---- short, scale ----------------------------------------------------
    short = check_short(SHORT_READS, out_dir)
    scale = check_scale_kernels(damage)

    # ---- deep ----------------------------------------------------------
    deep = check_deep(DEEP_READS, out_dir)

    kernels = []
    for kname, k in _build.KERNELS.items():
        cases = rows[kname]["cases"]
        main_case = cases[0]
        kernels.append({
            "name": kname, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": launches[kname],
            "stage_launches": stages["launches"][kname],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main_case["ms"], "wrapper_ms": main_case["wrapper_ms"],
            "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"],
            "cases": cases})
    phase("done", f"all phases passed in {time.perf_counter() - T0:.1f} s")
    print(smi_line, flush=True)
    print(json.dumps({"kernels": kernels, "stages": stages, "mlp": mlp,
                      "short": short, "scale": scale, "deep": deep}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
