"""Assembly parameters, mirroring the reference flag system.

One dataclass per run; field names, CLI flag spellings and defaults follow
LocalParameters (src/commons/LocalParameters.h:283-318) and the workflow
defaults (src/workflow/Nuclassembler.cpp:10-34, GuidedNuclassembler.cpp:
11-41).  `apply_nuclassemble_defaults` reproduces
setNuclAssemblerWorkflowDefaults.
"""
from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass


class ParamError(ValueError):
    """A flag failed validation; message names the CLI flag spelling."""


@dataclass
class Params:
    # --- core assembly loop -------------------------------------------------
    num_iterations: int = 12                # --num-iterations (workflow: 10)
    num_iterations_reads: int = 5           # --num-iter-reads-only (workflow: 4)
    kmer_size: int = 22                     # -k (contig phase; workflow 22)
    kmer_size_reads: int = 20               # --k-ancient-reads
    kmer_size_contigs: int = 22             # --k-ancient-contigs
    kmers_per_sequence: int = 200           # --kmer-per-seq-ancient
    kmers_per_sequence_scale: float = 0.2   # --kmer-per-seq-scale-ancient
    include_only_extendable_reads: bool = False
    include_only_extendable_contigs: bool = True
    hash_shift: int = 67                    # --hash-shift (Parameters.cpp:2336)
    ignore_multi_kmer: bool = True          # workflow forces true
    mask_mode: int = 0

    # --- alignment / filtering ---------------------------------------------
    seq_id_thr: float = 0.9                 # --min-seq-id (workflow 0.9)
    merge_seq_id_thr: float = 0.99          # --min-merge-seq-id
    ry_seq_id_thr: float = 0.99             # --min-ryseq-id
    corr_reads_ry_seq_id: float = 0.99      # --min-ryseq-id-corr-reads
    corr_reads_seq_id: float = 0.9          # --min-seqid-corr-reads
    corr_contig_seq_id: float = 0.9         # --min-seqid-corr-contigs
    eval_thr: float = 0.001                 # -e
    cov_thr: float = 0.0                    # -c
    cov_mode: int = 0
    aln_len_thr: int = 0                    # --min-aln-len
    max_seq_len: int = 300000               # --max-seq-len

    # --- ancient extension scoring -----------------------------------------
    random_align_penal: float = 0.85        # --ext-random-align
    excess_penal: float = 0.0625            # --excess-penalty
    likelihood_threshold: float = 0.5       # --likelihood-ratio-threshold
    ancient_damage_path: str = ""           # --ancient-damage (prefix)
    ancient_unsafe: bool = False            # --unsafe
    min_cov_safe: int = 5                   # --min-cov-safe

    # --- output / cycles ----------------------------------------------------
    min_contig_len: int = 500               # --min-contig-len
    cycle_check: bool = True                # --cycle-check
    chop_cycle: bool = True                 # --chop-cycle
    contig_output_mode: int = 1

    # --- redundancy reduction (guided workflow, GuidedNuclassembler.cpp:33-40)
    clust_seq_id_thr: float = 0.97          # --clust-min-seq-id
    clust_cov_thr: float = 0.99             # --clust-min-cov
    clust_cov_mode: int = 1
    clustering_mode: int = 2                # greedy incremental

    # --- runtime ------------------------------------------------------------
    threads: int = 8
    remove_tmp_files: bool = False
    delete_tmp_inc: bool = True
    db_mode: bool = False
    verbosity: int = 3
    compressed: int = 0                     # --compressed (DBWriter zstd role)
    split_memory_limit: str = "0"           # --split-memory-limit (0 = auto)
    # Plass coding filter (vestigial in the reference's ancient path:
    # compiled + parameterised but filternoncoding is unregistered,
    # src/commons/LocalParameters.h:119-120,283-285)
    filter_proteins: int = 1                # --filter-proteins
    protein_filter_threshold: float = 0.2   # --protein-filter-threshold
    # device kernel selection: "auto" = use the accelerator path when the
    # default JAX backend is not the host CPU; "1"/"0" force on/off.  Both
    # paths are bit-identical (tests/test_device_parity.py).
    use_device: str = "auto"

    # fields the USER explicitly set on the command line.  The reference
    # applies workflow defaults BEFORE parseParameters
    # (GuidedNuclassembler.cpp:45 vs :83), so user flags override them;
    # workflow-default application via `copy_defaults` skips these.
    explicit: frozenset = frozenset()

    def copy(self, **overrides) -> "Params":
        return dataclasses.replace(self, **overrides)

    def copy_defaults(self, **workflow_defaults) -> "Params":
        """Apply workflow defaults ONLY for fields the user did not set
        explicitly (the reference's setDefaults-then-parseParameters
        order: user flags win over workflow defaults)."""
        ov = {k: v for k, v in workflow_defaults.items()
              if k not in self.explicit}
        return dataclasses.replace(self, **ov) if ov else self

    def hash(self, *extra) -> str:
        """Parameter fingerprint keying checkpoint/tmp directories, the
        par.hashParameter analogue (GuidedNuclassembler.cpp:106-110 names
        the tmp dir by it so a changed flag can never resume stale
        stages).  `extra` folds in input identity (e.g. read counts)."""
        import hashlib
        items = [(f.name, getattr(self, f.name))
                 for f in dataclasses.fields(self)
                 # use_device is an impl choice; `explicit` is parse
                 # metadata (the resolved field VALUES carry the
                 # semantics) — neither may change the checkpoint key
                 if f.name not in ("use_device", "explicit")]
        text = repr(items) + "|" + repr(extra)
        return hashlib.sha1(text.encode()).hexdigest()[:16]

    def validate(self) -> "Params":
        """Typed range validation of every flag (the reference validates
        each parameter against a per-flag regex at parse time and exits
        with the offending flag named — Parameters.cpp parseParameters /
        MMseqsParameter::regex).  Raises ParamError naming the CLI flag."""
        flag_of = {field: flag for flag, (field, _t) in _FLAGS.items()}

        def bad(field, why):
            raise ParamError(f"{flag_of.get(field, field)}: {why} "
                             f"(got {getattr(self, field)!r})")

        for f in ("num_iterations", "kmers_per_sequence", "threads",
                  "min_contig_len"):
            v = getattr(self, f)
            if not isinstance(v, int) or v < 1:
                bad(f, "must be a positive integer")
        for f in ("num_iterations_reads", "min_cov_safe", "aln_len_thr",
                  "hash_shift"):
            v = getattr(self, f)
            if not isinstance(v, int) or v < 0:
                bad(f, "must be a non-negative integer")
        for f in ("kmer_size", "kmer_size_reads", "kmer_size_contigs"):
            v = getattr(self, f)
            # k <= 31: 2*31 = 62 content bits leave bit 63 free for the
            # canonical-strand flag in the packed u64 k-mer encoding
            # (native kmer_extract / kmermatcher_scan); k = 32 would
            # collide strand with content and corrupt grouping
            if not isinstance(v, int) or not 6 <= v <= 31:
                bad(f, "k-mer size must be in [6, 31] (2-bit packed u64 "
                       "with the strand flag in bit 63)")
        for f in ("seq_id_thr", "merge_seq_id_thr", "ry_seq_id_thr",
                  "corr_reads_ry_seq_id", "corr_reads_seq_id",
                  "corr_contig_seq_id", "cov_thr", "clust_seq_id_thr",
                  "clust_cov_thr", "likelihood_threshold"):
            v = getattr(self, f)
            if not 0.0 <= float(v) <= 1.0:
                bad(f, "must be in [0.0, 1.0]")
        # the reference attaches no validation regex to these
        # (LocalParameters.h), so only reject values the math cannot
        # take (log of a non-positive penalty / negative sampling scale)
        for f in ("random_align_penal", "excess_penal"):
            if not float(getattr(self, f)) > 0.0:
                bad(f, "must be > 0.0")
        if float(self.kmers_per_sequence_scale) < 0.0:
            bad("kmers_per_sequence_scale", "must be >= 0.0")
        if self.eval_thr < 0:
            bad("eval_thr", "must be >= 0")
        if self.num_iterations_reads > self.num_iterations:
            bad("num_iterations_reads",
                f"cannot exceed --num-iterations ({self.num_iterations})")
        if self.max_seq_len < 65:
            bad("max_seq_len", "must be >= 65")
        if self.cov_mode not in range(6):
            bad("cov_mode", "must be in 0..5")
        if self.clust_cov_mode not in range(6):
            bad("clust_cov_mode", "must be in 0..5")
        if self.verbosity not in range(4):
            bad("verbosity", "must be 0 (silent) .. 3 (info)")
        if self.use_device not in ("auto", "0", "1", "pallas", "mesh"):
            bad("use_device",
                "must be one of auto, 0, 1, pallas, mesh")
        if self.compressed not in (0, 1):
            bad("compressed", "must be 0 or 1")
        if self.filter_proteins not in (0, 1):
            bad("filter_proteins", "must be 0 or 1")
        if not 0.0 <= float(self.protein_filter_threshold) <= 1.0:
            bad("protein_filter_threshold", "must be in [0.0, 1.0]")
        if parse_byte_size(self.split_memory_limit) is None:
            bad("split_memory_limit",
                "must be 0 or <number>[T|G|M|K] (the reference's BYTE "
                "format, Parameters.cpp)")
        return self


def parse_byte_size(text: str) -> int | None:
    """Reference BYTE flag format (`^(0|[1-9]{1}[0-9]*(T|G|M|K)?)$`,
    e.g. --split-memory-limit 10G); returns bytes, or None if invalid."""
    import re
    m = re.fullmatch(r"0|([1-9][0-9]*)([TGMK]?)", str(text).strip())
    if m is None:
        return None
    if m.group(1) is None:
        return 0
    mult = {"": 1, "K": 1024, "M": 1024 ** 2, "G": 1024 ** 3,
            "T": 1024 ** 4}[m.group(2)]
    return int(m.group(1)) * mult


def apply_nuclassemble_defaults(p: Params) -> Params:
    """setNuclAssemblerWorkflowDefaults (src/workflow/Nuclassembler.cpp:10-34)."""
    return p.copy(num_iterations=10, num_iterations_reads=4, kmer_size=22,
                  seq_id_thr=0.9, merge_seq_id_thr=0.99, cov_thr=0.0,
                  eval_thr=0.001, max_seq_len=300000)


_FLAGS = {
    "--num-iterations": ("num_iterations", int),
    "--num-iter-reads-only": ("num_iterations_reads", int),
    "-k": ("kmer_size", int),
    "--k-ancient-reads": ("kmer_size_reads", int),
    "--k-ancient-contigs": ("kmer_size_contigs", int),
    "--kmer-per-seq-ancient": ("kmers_per_sequence", int),
    "--kmer-per-seq-scale-ancient": ("kmers_per_sequence_scale", float),
    "--include-only-extendable": ("include_only_extendable_contigs", bool),
    "--hash-shift": ("hash_shift", int),
    "--min-seq-id": ("seq_id_thr", float),
    "--min-merge-seq-id": ("merge_seq_id_thr", float),
    "--min-ryseq-id": ("ry_seq_id_thr", float),
    "--min-ryseq-id-corr-reads": ("corr_reads_ry_seq_id", float),
    "--min-seqid-corr-reads": ("corr_reads_seq_id", float),
    "--min-seqid-corr-contigs": ("corr_contig_seq_id", float),
    "-e": ("eval_thr", float),
    "--max-seq-len": ("max_seq_len", int),
    "--ext-random-align": ("random_align_penal", float),
    "--excess-penalty": ("excess_penal", float),
    "--likelihood-ratio-threshold": ("likelihood_threshold", float),
    "--ancient-damage": ("ancient_damage_path", str),
    "--unsafe": ("ancient_unsafe", bool),
    "--min-cov-safe": ("min_cov_safe", int),
    "--min-contig-len": ("min_contig_len", int),
    "--cycle-check": ("cycle_check", bool),
    "--chop-cycle": ("chop_cycle", bool),
    "--clust-min-seq-id": ("clust_seq_id_thr", float),
    "--clust-min-cov": ("clust_cov_thr", float),
    "--threads": ("threads", int),
    "--remove-tmp-files": ("remove_tmp_files", bool),
    "--delete-tmp-inc": ("delete_tmp_inc", bool),
    "--db-mode": ("db_mode", bool),
    "--compressed": ("compressed", int),
    "--split-memory-limit": ("split_memory_limit", str),
    "--filter-proteins": ("filter_proteins", int),
    "--protein-filter-threshold": ("protein_filter_threshold", float),
    "-v": ("verbosity", int),
    "--use-device": ("use_device", str),
}


def add_flags(parser: argparse.ArgumentParser) -> None:
    for flag, (field, typ) in _FLAGS.items():
        if typ is bool:
            parser.add_argument(flag, dest=field, type=int, choices=(0, 1),
                                default=None)
        else:
            parser.add_argument(flag, dest=field, type=typ, default=None)


def params_from_args(args: argparse.Namespace) -> Params:
    p = Params()
    over = {}
    for _, (field, typ) in _FLAGS.items():
        v = getattr(args, field, None)
        if v is not None:
            over[field] = bool(v) if typ is bool else v
    over["explicit"] = frozenset(over.keys())
    return p.copy(**over).validate()
