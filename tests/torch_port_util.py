"""Shared inputs of the tests/test_torch_*.py parity tests: the same
synthetic data, made from numpy seeds, for the JAX package and its
PyTorch port (carpedeam_tpu_torch)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from carpedeam_tpu.damage import DamageModel as JaxDamageModel
from carpedeam_tpu.io.seqdb import SeqDB as JaxSeqDB
from carpedeam_tpu_torch import convert, workload
from carpedeam_tpu_torch.io.seqdb import SeqDB

# the suite runs several test workers on the same cores: one intra-op
# thread per worker keeps the plain PyTorch versions from oversubscribing
torch.set_num_threads(1)


def to_jax_db(db: SeqDB) -> JaxSeqDB:
    return JaxSeqDB(db.data.copy(), db.offsets.copy(), db.lengths.copy(),
                    db.keys.copy(), db.ext.copy(),
                    list(db.headers) if db.headers else None)


def damage_pair(sub5p, sub3p):
    """(JAX DamageModel, port DamageModel) from the same profile rates;
    the port's comes through convert.from_reference."""
    jdm = JaxDamageModel.from_rates(sub5p, sub3p)
    arrays = {k: getattr(jdm, k) for k in
              ("fwd", "rev", "fwd_ld", "rev_ld", "sub5p", "sub3p")}
    tdm, _ = convert.from_reference(arrays, {})
    return jdm, tdm


def reads_world(seed: int, n_reads: int):
    """(port reads, JAX reads, JAX damage, port damage)."""
    db, (s5, s3) = workload.generate(seed, n_reads)
    jdm, tdm = damage_pair(s5, s3)
    return db, to_jax_db(db), jdm, tdm


def params_pair(**fields):
    """(JAX Params, port Params) with the same field values."""
    from carpedeam_tpu.params import Params as JaxParams
    from carpedeam_tpu_torch.params import Params
    jp = JaxParams(**fields)
    return jp, Params(**dataclasses.asdict(jp))


def contig_db(seed: int, n: int, lo: int, hi: int, genome_len: int,
              sub_rate: float = 0.005) -> SeqDB:
    """n substrings (lengths lo..hi, random strand, `sub_rate`
    substitutions) of a random genome: contig-like sequences."""
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
        mut = rng.random(ln) < sub_rate
        s[mut] = bases[rng.integers(0, 4, int(mut.sum()))]
        if rng.random() < 0.5:
            s = comp[s[::-1]]
        seqs.append(s.tobytes())
    return SeqDB.from_sequences(seqs)


def same_seqs(a, b) -> bool:
    return len(a) == len(b) and all(
        int(a.keys[i]) == int(b.keys[i])
        and bytes(a.seq_bytes(i)) == bytes(b.seq_bytes(i))
        for i in range(len(a)))


_CODON = {a + b + c: aa for (a, b, c), aa in zip(
    ((a, b, c) for a in "TCAG" for b in "TCAG" for c in "TCAG"),
    "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG")}


def translate(s: str) -> str:
    """Frame-0 translation in the standard genetic code ('*' = stop)."""
    return "".join(_CODON[s[i:i + 3]] for i in range(0, len(s) - 2, 3))


def guided_world(seed: int, n: int = 20, genome_len: int = 600):
    """Nucleotide fragments for guidedassembleresult: `n` overlapping
    pieces (60-150 bases) of a random genome without T (so no stop codon
    by chance), about a quarter of them with a stop codon added at the
    start and a quarter at the end.  Returns the sequences (str)."""
    rng = np.random.default_rng(seed)
    genome = "".join("ACG"[b] for b in rng.integers(0, 3, genome_len))
    seqs = []
    for _ in range(n):
        ln = int(rng.integers(60, 151))
        s0 = int(rng.integers(0, genome_len - ln))
        s = genome[s0:s0 + ln]
        u = rng.random()
        if u < 0.25:
            s = "TAA" + s[3:]
        elif u < 0.5:
            s = s[:-3] + "TGA"
        seqs.append(s)
    return seqs


def same_outputs(mine, ref) -> int:
    """Assert that directories `mine` and `ref` hold the same files with
    equal contents (chip_smoke.dir_contents: .npz checkpoints member by
    member); returns the number of files."""
    import chip_smoke
    a, b = chip_smoke.dir_contents(mine), chip_smoke.dir_contents(ref)
    assert sorted(a) == sorted(b)
    for name in a:
        assert a[name] == b[name], name
    return len(a)
