"""`--use-device 1` (ops/rescore_device.py, ops/correction_device.py) and
CARPEDEAM_KMER_DEVICE=1 (ops/kmer_device.py) in the port, on the CPU,
against the JAX package's rescorediagonal_tpu / correction_tpu and its
pipeline, and against the port's host oracles: identical AlnDB columns,
corrected bytes and FASTA."""
import numpy as np
import pytest

import carpedeam_tpu.pipeline as JP
from carpedeam_tpu.io.seqdb import SeqDB as JaxSeqDB
from carpedeam_tpu.kmer.matcher import kmermatcher as jax_kmermatcher
from carpedeam_tpu.ops.correction_tpu import correction_tpu
from carpedeam_tpu.ops.rescore_tpu import rescorediagonal_tpu
from carpedeam_tpu.stages.correction import correction as jax_correction
from carpedeam_tpu.stages.rescorediagonal import \
    rescorediagonal as jax_rescorediagonal
from carpedeam_tpu_torch import _build, pipeline, utils
from carpedeam_tpu_torch.io.seqdb import SeqDB
from carpedeam_tpu_torch.kmer.matcher import kmermatcher
from carpedeam_tpu_torch.ops import kmer_device
from carpedeam_tpu_torch.ops.correction_device import \
    correction_device_stage
from carpedeam_tpu_torch.ops.planes import device_planes
from carpedeam_tpu_torch.ops.rescore_device import rescorediagonal_device
from carpedeam_tpu_torch.stages.correction import correction
from carpedeam_tpu_torch.stages.rescorediagonal import rescorediagonal
from torch_port_util import (contig_db, params_pair, reads_world, same_seqs,
                             to_jax_db)


@pytest.fixture(scope="module")
def world():
    db, jdb, jdm, tdm = reads_world(81, 1500)
    pref = kmermatcher(db, 20, 200, 0.2, False)
    jpref = jax_kmermatcher(jdb, 20, 200, 0.2, False)
    return db, jdb, jdm, tdm, pref, jpref


def test_rescorediagonal_device_matches_jax_and_host(world):
    db, jdb, _, _, pref, jpref = world
    mine = rescorediagonal_device(db, pref, 0.9, device="cpu")
    assert len(mine.qkey) > 1000
    assert mine.to_text() == rescorediagonal_tpu(jdb, jpref, 0.9).to_text()
    assert mine.to_text() == rescorediagonal(db, pref, 0.9).to_text()


def test_rescorediagonal_device_with_narrow_shared_planes():
    """Sequences longer than the pipeline's 512-wide planes: the stage
    packs full-width planes, so the AlnDB equals the host's and the JAX
    function's own (given no planes)."""
    db = contig_db(82, 150, 200, 1200, 30_000)
    pref = kmermatcher(db, 22, 200, 0.2, False)
    planes, lengths = device_planes(db, max_len=512, device="cpu")
    mine = rescorediagonal_device(db, pref, 0.9, planes=planes,
                                  lengths=lengths, device="cpu")
    jdb = to_jax_db(db)
    ref = rescorediagonal_tpu(jdb, jax_kmermatcher(jdb, 22, 200, 0.2,
                                                   False), 0.9)
    assert mine.to_text() == ref.to_text()
    assert mine.to_text() == rescorediagonal(db, pref, 0.9).to_text()


def test_correction_device_matches_jax_and_host(world):
    db, jdb, jdm, tdm, pref, jpref = world
    aln = rescorediagonal(db, pref, 0.9)
    mine = correction_device_stage(db, aln, tdm, 0.99, 0.9, device="cpu")
    ref = correction_tpu(jdb, jax_rescorediagonal(jdb, jpref, 0.9), jdm,
                         0.99, 0.9)
    assert bytes(mine.data) == bytes(ref.data)
    assert bytes(mine.data) == bytes(correction(db, aln, tdm, 0.99,
                                                0.9).data)
    assert (mine.data != db.data).sum() > 10


def test_correction_device_exact_at_ry_threshold(world):
    """A record exactly at the dynamic RY threshold (49/50 RY matches
    against floor(0.98 * 1000) / 1000) is kept, as numpy's IEEE f32
    division keeps it (the port of the JAX package's regression test)."""
    _, _, jdm, tdm, _, _ = world
    rng = np.random.default_rng(7)
    q = rng.integers(0, 4, 60)
    t = q[:50].copy()
    t[25] = {0: 1, 1: 0, 2: 3, 3: 2}[int(t[25])]    # A<->C / G<->T breaks RY
    enc = np.frombuffer(b"ACGT", dtype=np.uint8)
    seqs = [enc[q].tobytes(), enc[t].tobytes()]
    db = SeqDB.from_sequences(seqs)
    aln = rescorediagonal(db, kmermatcher(db, 20, 200, 0.2, False), 0.9)
    mine = correction_device_stage(db, aln, tdm, 0.99, 0.9, device="cpu")
    ora = correction(db, aln, tdm, 0.99, 0.9)
    jdb = JaxSeqDB.from_sequences(seqs)
    jaln = jax_rescorediagonal(jdb, jax_kmermatcher(jdb, 20, 200, 0.2,
                                                    False), 0.9)
    ref = correction_tpu(jdb, jaln, jdm, 0.99, 0.9)
    assert jax_correction(jdb, jaln, jdm, 0.99, 0.9).data.tobytes() \
        == ref.data.tobytes()
    for i in range(len(db)):
        assert bytes(mine.seq_bytes(i)) == bytes(ora.seq_bytes(i)) \
            == bytes(ref.seq_bytes(i))


def test_nuclassemble_use_device_1_matches_jax():
    """--use-device 1 against the JAX package's --use-device 1 and its
    host oracles over four iterations (two read, two contig)."""
    db, jdb, jdm, tdm = reads_world(83, 1200)
    jp, tp = params_pair(use_device="1", num_iterations=4,
                         num_iterations_reads=2, min_contig_len=0)
    utils.coverage_reset()
    mine, cyc, _ = pipeline.nuclassemble(db, tp, tdm, device="cpu")
    cov = utils.coverage_summary()
    assert cov["rescorediagonal"]["device_pct"] == 100.0
    assert cov["correction"]["device_pct"] == 100.0
    assert len(mine) > 100
    for jparams in (jp, jp.copy(use_device="0")):
        ref, ref_cyc, _ = JP.nuclassemble(jdb, jparams, jdm)
        assert cyc == ref_cyc
        assert same_seqs(mine, ref)


def test_ancient_assemble_use_device_1_and_kmer_device_fasta(tmp_path,
                                                            monkeypatch):
    """The FASTA of --use-device 1, and of CARPEDEAM_KMER_DEVICE=1 (the
    device kmermatcher on the pipeline's device, every call counted on
    it), byte-identical to the JAX package's over all ten iterations."""
    db, jdb, jdm, tdm = reads_world(84, 1500)
    jp, tp = params_pair(use_device="0", min_contig_len=100)
    JP.ancient_assemble(jdb, jp, jdm, out_fasta=str(tmp_path / "jax.fa"))
    ref = (tmp_path / "jax.fa").read_bytes()
    assert ref.count(b">") > 5
    pipeline.ancient_assemble(db, tp.copy(use_device="1"), tdm,
                              out_fasta=str(tmp_path / "one.fa"),
                              device="cpu")
    assert (tmp_path / "one.fa").read_bytes() == ref
    monkeypatch.setenv("CARPEDEAM_KMER_DEVICE", "1")
    utils.coverage_reset()
    pipeline.ancient_assemble(db, tp.copy(use_device="auto"), tdm,
                              out_fasta=str(tmp_path / "kmer.fa"),
                              device="cpu")
    assert (tmp_path / "kmer.fa").read_bytes() == ref
    km = utils.coverage_summary()["kmermatcher"]
    assert km["device"] == 10 and km["host"] == 0


def test_kmer_device_packing_budget_takes_the_host_path(monkeypatch):
    """Past the packing budget (made small here) the kmermatcher takes the
    host path, counted as such; the result is unchanged."""
    db, jdb, jdm, tdm = reads_world(85, 600)
    monkeypatch.setenv("CARPEDEAM_KMER_DEVICE", "1")
    monkeypatch.setattr(kmer_device, "B_ID", 6)
    _, tp = params_pair(num_iterations=2, num_iterations_reads=1,
                        min_contig_len=0)
    utils.coverage_reset()
    mine, _, _ = pipeline.nuclassemble(db, tp, tdm, device="cpu")
    assert utils.coverage_summary()["kmermatcher"]["host"] == 2
    monkeypatch.setenv("CARPEDEAM_KMER_DEVICE", "0")
    ref, _, _ = pipeline.nuclassemble(db, tp, tdm, device="cpu")
    assert same_seqs(mine, ref)


def test_kmer_device_launches_nothing_on_the_cpu(monkeypatch):
    """CARPEDEAM_KMER_DEVICE=1 with device="cpu" runs the plain versions:
    no kernel launch."""
    db, _, _, tdm = reads_world(86, 300)
    monkeypatch.setenv("CARPEDEAM_KMER_DEVICE", "1")
    _build.reset_launch_counts()
    _, tp = params_pair(num_iterations=1, num_iterations_reads=1,
                        min_contig_len=0)
    pipeline.nuclassemble(db, tp, tdm, device="cpu")
    assert all(v == 0 for v in _build.launch_counts().values())
