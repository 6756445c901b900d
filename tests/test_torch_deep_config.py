"""The deep long-contig configuration (BASELINE.json config 4, as
tools/run_deep_config.py runs it: `--unsafe 1 --min-merge-seq-id 0.97
--num-iterations 12 --split-memory-limit <limit>` on a mock ancient
community): the port's mock-community workload against the JAX repo's
generator, its flags against the JAX CLI's, its bounded k-mer split and
the whole configuration against the JAX package, byte for byte."""
import argparse
import dataclasses
import hashlib
import importlib.util
import os

import numpy as np
import pytest

import carpedeam_tpu.cli as jax_cli
import carpedeam_tpu.pipeline as JP
import chip_smoke
from carpedeam_tpu.kmer import matcher as jax_matcher
from carpedeam_tpu.params import add_flags as jax_add_flags
from carpedeam_tpu.params import params_from_args as jax_params_from_args
from carpedeam_tpu_torch import cli, pipeline, workload
from carpedeam_tpu_torch.io.seqdb import SeqDB
from carpedeam_tpu_torch.kmer import matcher
from torch_port_util import damage_pair, to_jax_db

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _digest(db) -> str:
    return hashlib.sha256(db.data[:db.total_residues].tobytes()
                          + db.lengths.astype(np.int64).tobytes()).hexdigest()


# sha256 of the reads and lengths that workload.generate returned before it
# took `species`
@pytest.mark.parametrize("seed,n,digest", [
    (1, 2000,
     "403f2a90fede1b7dd356eff97ef17ab4e5839e532dccbcd4fb1c76c20f96605b"),
    (51, 3000,
     "188ee2079efa93f7306b7f7022ded5d507a2a2946c6debe7a630ca0007515a41"),
])
def test_single_species_workload_is_unchanged(seed, n, digest):
    db, _ = workload.generate(seed, n)
    assert _digest(db) == digest
    assert _digest(workload.generate(seed, n, species=1)[0]) == digest


def _make_workload_tool():
    spec = importlib.util.spec_from_file_location(
        "make_workload", os.path.join(REPO, "tools", "make_workload.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("species", [1, 3, 10])
def test_mock_community_is_the_tools_draw(tmp_path, species):
    """tools/make_workload.py with the port's damage rates written as
    profile files, read back as createdb reads it, gives the port's reads
    byte for byte (the two generators also agree at one species)."""
    prefix = str(tmp_path / "dmg_")
    _, rates = workload.generate(0, 1)
    chip_smoke.write_profiles(prefix, *rates)
    fq = str(tmp_path / "reads.fq")
    _make_workload_tool().generate(fq, 4000, 20.0, prefix, 17,
                                   species=species)
    tool = SeqDB.from_fastx(fq, shuffle=True)
    mine, _ = workload.generate(17, 4000, species=species)
    assert np.array_equal(tool.lengths, mine.lengths)
    assert tool.data[:tool.total_residues].tobytes() \
        == mine.data[:mine.total_residues].tobytes()


def _cli_params(monkeypatch, main, module, argv):
    """The Params a CLI's ancient_assemble builds from `argv`."""
    got = {}

    def dispatch(args):
        got["p"] = module.params_from_args(args)
        return 0
    monkeypatch.setattr(module, "_dispatch", dispatch)
    assert main(["ancient_assemble", "r.fq", "out.fa", "tmp", *argv]) == 0
    return got["p"]


@pytest.mark.parametrize("use_device", [None, "0"])
def test_deep_flags_give_the_jax_cli_params(monkeypatch, use_device):
    """Both CLIs turn the deep flags into equal Params, explicit fields
    included, and the guided workflow defaults that ancient_assemble
    applies keep the user's 12 iterations in both."""
    argv = list(chip_smoke.DEEP_FLAGS)
    if use_device:
        argv += ["--use-device", use_device]
    mine = _cli_params(monkeypatch, cli.main, cli, argv)
    ref = _cli_params(monkeypatch, jax_cli.main, jax_cli, argv)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.ancient_unsafe and mine.merge_seq_id_thr == 0.97
    assert mine.split_memory_limit == "128M"
    guided = dict(num_iterations=10, num_iterations_reads=5,
                  max_seq_len=200000)
    mine_g = mine.copy_defaults(**guided)
    assert dataclasses.asdict(mine_g) \
        == dataclasses.asdict(ref.copy_defaults(**guided))
    assert (mine_g.num_iterations, mine_g.num_iterations_reads,
            mine_g.max_seq_len) == (12, 5, 200000)
    if use_device:
        assert dataclasses.asdict(chip_smoke.deep_params(use_device)) \
            == dataclasses.asdict(mine)


@pytest.mark.parametrize("k,only_ext", [(20, False), (22, True)],
                         ids=["read-phase", "contig-phase"])
def test_bounded_split_kmermatcher_matches_jax(monkeypatch, k, only_ext):
    """A max_block_residues that cuts a 3-species community into at least
    three extraction blocks gives the JAX package's PrefDB under the same
    argument, and the unsplit PrefDB."""
    db, _ = workload.generate(7, 3000, species=3)
    jdb = to_jax_db(db)
    mbr = db.total_residues // 4
    blocks = []
    real = matcher.extract_selected_kmers_batched

    def counted(seqdb, *args, **kw):
        if kw.get("max_block_residues") is None:
            blocks.append(len(seqdb))
        return real(seqdb, *args, **kw)
    monkeypatch.setattr(matcher, "extract_selected_kmers_batched", counted)
    mine = matcher.kmermatcher(db, k, 200, 0.2, only_ext,
                               max_block_residues=mbr)
    ref = jax_matcher.kmermatcher(jdb, k, 200, 0.2, only_ext,
                                  max_block_residues=mbr)
    assert len(blocks) >= 3 and sum(blocks) == len(db)
    assert len(mine.qkey) > 1000
    assert mine.to_text() == ref.to_text()
    whole = matcher.kmermatcher(db, k, 200, 0.2, only_ext,
                                max_block_residues=db.total_residues)
    assert mine.to_text() == whole.to_text()


@pytest.mark.parametrize("limit,residues", [("128M", 2684354),
                                            ("1M", 1 << 20)])
def test_split_memory_limit_sets_the_block_size(monkeypatch, limit,
                                                residues):
    """--split-memory-limit gives extraction blocks of limit / 50
    residues, at least 2^20, in both packages' kmermatcher routing."""
    monkeypatch.delenv("CARPEDEAM_KMER_DEVICE", raising=False)
    p = chip_smoke.deep_params("0").copy(split_memory_limit=limit)
    got = []

    def fake(*args, max_block_residues=None, **kw):
        got.append(max_block_residues)
    monkeypatch.setattr(pipeline, "kmermatcher", fake)
    monkeypatch.setattr(JP, "kmermatcher", fake)
    pipeline._pick_kmermatcher(p, "cpu")(None, 20, 200, 0.2, False)
    JP._pick_kmermatcher("0", p)(None, 20, 200, 0.2, False)
    assert got == [residues, residues]


def test_deep_configuration_fasta_matches_jax(tmp_path):
    """The whole configuration on a 3-species mock community of 3,000
    reads: the JAX package's host route (`--use-device 0`) and the
    port's kernel route on the CPU (the kernels' plain versions) write
    the same FASTA bytes, and the port's sequences reach the 4096
    correction and 8192 rescore levels.  The flags are chip_smoke's
    DEEP_FLAGS; at 151,105 residues the 2^20-residue floor of the block
    size keeps the k-mer extraction in one block, so the split binds
    only in test_bounded_split_kmermatcher_matches_jax."""
    db, (s5, s3) = workload.generate(3, 3000, species=3)
    jdm, tdm = damage_pair(s5, s3)
    ap = argparse.ArgumentParser()
    jax_add_flags(ap)
    jp = jax_params_from_args(ap.parse_args(
        [*chip_smoke.DEEP_FLAGS, "--use-device", "0"]))
    JP.ancient_assemble(to_jax_db(db), jp, jdm,
                        out_fasta=str(tmp_path / "jax.fa"))
    trace = chip_smoke.DeepTrace(jp.kmer_size_reads)
    with trace.installed():
        rep = pipeline.ancient_assemble(db, chip_smoke.deep_params("auto"),
                                        tdm,
                                        out_fasta=str(tmp_path / "port.fa"),
                                        device="cpu")
    assert len(trace.longest) == 12
    assert len(rep) >= 2 and int(rep.lengths.max()) > 2048
    assert (tmp_path / "port.fa").read_bytes() \
        == (tmp_path / "jax.fa").read_bytes()
    levels = {(k, lvl) for k, _, lvl in trace.levels}
    assert {("rescore_pairs", 8192), ("correction", 4096)} <= levels
    # the same sequences grow on the port's host route
    host = chip_smoke.DeepTrace(jp.kmer_size_reads)
    with host.installed():
        pipeline.ancient_assemble(db, chip_smoke.deep_params("0"), tdm,
                                  out_fasta=str(tmp_path / "host.fa"))
    assert host.longest == trace.longest and not host.levels
    assert (tmp_path / "host.fa").read_bytes() \
        == (tmp_path / "port.fa").read_bytes()
