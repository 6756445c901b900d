"""BASELINE.json config 2, heavy-damage short reads (about 35 bp mean,
terminal C->T and G->A near 0.3, `--num-iter-reads-only 5
--num-iterations 14`): the port's draw against the JAX repo's generator,
its flags against the JAX CLI's, and the whole configuration against the
JAX package, byte for byte."""
import argparse
import dataclasses
import importlib.util
import os

import numpy as np
import pytest

import carpedeam_tpu.cli as jax_cli
import carpedeam_tpu.pipeline as JP
import chip_smoke
from carpedeam_tpu.params import add_flags as jax_add_flags
from carpedeam_tpu.params import params_from_args as jax_params_from_args
from carpedeam_tpu_torch import cli, pipeline
from carpedeam_tpu_torch.io.seqdb import SeqDB
from torch_port_util import damage_pair, to_jax_db

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _make_workload_tool():
    spec = importlib.util.spec_from_file_location(
        "make_workload", os.path.join(REPO, "tools", "make_workload.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed,n", [(17, 4000), (5, 3000)])
def test_short_reads_are_the_tools_draw(tmp_path, seed, n):
    """tools/make_workload.py with config 2's lengths and its damage rates
    written as profile files, read back as createdb reads it, gives the
    port's reads byte for byte; the reads sit near k (mean about 35)."""
    prefix = str(tmp_path / "dmg_")
    _, rates = chip_smoke.short_reads(0, 1)
    chip_smoke.write_profiles(prefix, *rates)
    fq = str(tmp_path / "reads.fq")
    _make_workload_tool().generate(fq, n, 20.0, prefix, seed, min_len=25,
                                   mean_len=35.0)
    tool = SeqDB.from_fastx(fq, shuffle=True)
    mine, _ = chip_smoke.short_reads(seed, n)
    assert np.array_equal(tool.lengths, mine.lengths)
    assert tool.data[:tool.total_residues].tobytes() \
        == mine.data[:mine.total_residues].tobytes()
    assert int(mine.lengths.min()) == 25 and 33 < mine.lengths.mean() < 37


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
def test_short_flags_give_the_jax_cli_params(monkeypatch, use_device):
    """Both CLIs turn config 2's flags into equal Params, and the guided
    workflow defaults that ancient_assemble applies keep the user's 5 + 9
    iterations in both."""
    argv = list(chip_smoke.SHORT_FLAGS)
    if use_device:
        argv += ["--use-device", use_device]
    mine = _cli_params(monkeypatch, cli.main, cli, argv)
    ref = _cli_params(monkeypatch, jax_cli.main, jax_cli, argv)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    guided = dict(num_iterations=10, num_iterations_reads=5,
                  max_seq_len=200000)
    mine_g = mine.copy_defaults(**guided)
    assert dataclasses.asdict(mine_g) \
        == dataclasses.asdict(ref.copy_defaults(**guided))
    assert (mine_g.num_iterations, mine_g.num_iterations_reads) == (14, 5)
    if use_device:
        assert dataclasses.asdict(chip_smoke.default_params(
            use_device, chip_smoke.SHORT_FLAGS)) == dataclasses.asdict(mine)


def _last_merge(monkeypatch, module, out: list):
    """Keep each contig_merge output of `module`'s pipeline in `out`."""
    real = module.contig_merge

    def wrapper(*args, **kw):
        db = real(*args, **kw)
        out.append(db)
        return db
    monkeypatch.setattr(module, "contig_merge", wrapper)


def _db_bytes(db) -> tuple:
    return (np.asarray(db.keys).tolist(), np.asarray(db.ext).tolist(),
            [bytes(db.seq_bytes(i)) for i in range(len(db))])


@pytest.mark.parametrize("use_device", ["auto", "0"],
                         ids=["kernel-route", "host-route"])
def test_short_configuration_matches_jax(tmp_path, monkeypatch, use_device):
    """Config 2 on a seeded 3,000-read draw: the JAX package's host route
    (`--use-device 0`) and the port (the kernel route on the CPU, the
    kernels' plain versions; or `--use-device 0`) write the same FASTA
    bytes.  At this size no contig reaches --min-contig-len 500, so the
    last contig iteration's DB (keys, flags, bytes, before that filter) is
    held equal too."""
    db, (s5, s3) = chip_smoke.short_reads(5, 3000)
    jdm, tdm = damage_pair(s5, s3)
    ap = argparse.ArgumentParser()
    jax_add_flags(ap)
    jp = jax_params_from_args(ap.parse_args(
        [*chip_smoke.SHORT_FLAGS, "--use-device", "0"]))
    jax_dbs, port_dbs = [], []
    _last_merge(monkeypatch, JP, jax_dbs)
    _last_merge(monkeypatch, pipeline, port_dbs)
    JP.ancient_assemble(to_jax_db(db), jp, jdm,
                        out_fasta=str(tmp_path / "jax.fa"))
    pipeline.ancient_assemble(
        db, chip_smoke.default_params(use_device, chip_smoke.SHORT_FLAGS),
        tdm, out_fasta=str(tmp_path / "port.fa"), device="cpu")
    assert len(jax_dbs) == len(port_dbs) == 9
    assert (tmp_path / "port.fa").read_bytes() \
        == (tmp_path / "jax.fa").read_bytes()
    assert _db_bytes(port_dbs[-1]) == _db_bytes(jax_dbs[-1])
    assert int(port_dbs[-1].lengths.max()) > 2 * int(db.lengths.max())
