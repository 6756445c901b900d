"""Paired-end input in the port: stages/mergereads.py (FLASH merging)
against the JAX package's copy, and the CLI's `ancient_assemble R1 R2
OUT TMP` form against carpedeam_tpu.cli on the CPU."""
import numpy as np
import pytest

from carpedeam_tpu import cli as jax_cli
from carpedeam_tpu.stages import mergereads as JM
from carpedeam_tpu_torch import cli, workload
from carpedeam_tpu_torch.stages import mergereads as M

import chip_smoke


def _write_pairs(path1, path2, rng, db, lo=30, hi=80):
    """R1/R2 FASTQ of the reads of `db`: R1 a prefix, R2 the reverse
    complement of a suffix (lengths lo..hi, so long reads give pairs that
    do not overlap), random qualities, a few 'N' bases."""
    comp = np.full(256, ord("N"), dtype=np.uint8)
    comp[np.frombuffer(b"ACGT", np.uint8)] = np.frombuffer(b"TGCA", np.uint8)
    with open(path1, "w") as f1, open(path2, "w") as f2:
        for i in range(len(db)):
            s = db.seq_bytes(i).copy()
            if rng.random() < 0.05:
                s[rng.integers(0, len(s))] = ord("N")
            n1, n2 = (int(x) for x in rng.integers(lo, hi + 1, 2))
            a = s[:n1].tobytes().decode()
            b = comp[s[-n2:][::-1]].tobytes().decode()
            q1 = "".join(chr(33 + int(x)) for x in rng.integers(2, 41, len(a)))
            q2 = "".join(chr(33 + int(x)) for x in rng.integers(2, 41, len(b)))
            f1.write(f"@p{i} 1:N:0\n{a}\n+\n{q1}\n")
            f2.write(f"@p{i} 2:N:0\n{b}\n+\n{q2}\n")


def test_mergereads_matches_jax(tmp_path):
    """Two file pairs (R1a R2a R1b R2b): merged and passed-through pairs,
    the merged SeqDB's data, lengths, keys and headers equal."""
    rng = np.random.default_rng(91)
    paths = []
    for j, seed in enumerate((92, 93)):
        db, _ = workload.generate(seed, 700)
        p1, p2 = tmp_path / f"a{j}_R1.fq", tmp_path / f"a{j}_R2.fq"
        _write_pairs(p1, p2, rng, db)
        paths += [str(p1), str(p2)]
    mine = M.mergereads(paths)
    ref = JM.mergereads(paths)
    for f in ("data", "lengths", "keys", "ext"):
        assert np.array_equal(getattr(mine, f), getattr(ref, f)), f
    assert mine.headers == ref.headers
    # some pairs merged, some kept as two reads (no overlap)
    assert 1400 < len(mine) < 2800


def test_combine_pairs_match_jax():
    """The batched overlap scan and the per-pair splice on random pairs
    with 'N' bases, equal qualities and mismatches."""
    rng = np.random.default_rng(94)
    bases = np.frombuffer(b"ACGTN", dtype=np.uint8)
    P, L = 300, 90
    p1 = bases[rng.choice(5, (P, L), p=[.24, .24, .24, .24, .04])]
    p2 = p1[:, ::-1].copy()
    mut = rng.random(p2.shape) < 0.05
    p2[mut] = bases[rng.integers(0, 5, int(mut.sum()))]
    q1 = rng.integers(35, 45, (P, L)).astype(np.uint8)
    q2 = rng.integers(35, 45, (P, L)).astype(np.uint8)
    l1 = rng.integers(20, L + 1, P)
    l2 = rng.integers(20, L + 1, P)
    got = M.combine_pairs_batch(p1, q1, l1, p2, q2, l2)
    assert np.array_equal(got, JM.combine_pairs_batch(p1, q1, l1, p2, q2,
                                                      l2))
    for j in range(0, P, 7):
        a = (p1[j, :l1[j]], q1[j, :l1[j]], p2[j, :l2[j]], q2[j, :l2[j]])
        assert M.combine_pair(*a) == JM.combine_pair(*a)


def test_cli_paired_end_matches_jax_cli(tmp_path):
    """`ancient_assemble R1 R2 OUT TMP` in the port (plain versions on the
    CPU) writes the JAX package's FASTA."""
    db, rates = workload.generate(95, 2000, coverage=8.0)
    r1, r2 = str(tmp_path / "R1.fq"), str(tmp_path / "R2.fq")
    chip_smoke.write_paired(db, r1, r2)
    prefix = str(tmp_path / "dmg_")
    chip_smoke.write_profiles(prefix, *rates)
    flags = ["--ancient-damage", prefix, "--min-contig-len", "100",
             "-v", "0"]
    assert jax_cli.main(["ancient_assemble", r1, r2,
                         str(tmp_path / "jax.fa"), str(tmp_path / "jt"),
                         *flags]) == 0
    assert cli.main(["ancient_assemble", r1, r2, str(tmp_path / "port.fa"),
                     str(tmp_path / "pt"), "--device", "cpu",
                     *flags]) == 0
    ref = (tmp_path / "jax.fa").read_bytes()
    assert ref.count(b">") > 5
    assert (tmp_path / "port.fa").read_bytes() == ref


@pytest.mark.parametrize("n_files", [0, 3])
def test_cli_rejects_unpaired_file_lists(tmp_path, n_files, capsys):
    """READS OUT TMP needs one reads file or whole pairs: a bad
    parameter, exit 1."""
    files = [str(tmp_path / f"r{i}.fq") for i in range(n_files)]
    rc = cli.main(["ancient_assemble", *files, str(tmp_path / "o.fa"),
                   str(tmp_path / "t"), "--device", "cpu"])
    assert rc == 1
    assert "R1 R2" in capsys.readouterr().err
