"""The port's stage subcommands against the JAX package's CLI on the CPU.

The JAX CLI runs a chain of subcommands once (createdb -> kmermatcher ->
rescorediagonal -> ancient_correction -> ancient_read_assemble, then
kmermatcher -> rescorediagonal -> ancient_contig_merge on the read-phase
output, createhdb, convert2fasta; the same stages on a contig-phase DB;
mergereads on a paired FASTQ; cyclecheck on a FASTA with circular
sequences; guidedassembleresult on translated fragments).  Each case runs
one subcommand of the port (`--device cpu` where it takes the flag: the
kernels' plain versions) on that step's inputs, and every file it writes
must equal the JAX CLI's (.npz checkpoints member by member).
"""
import os

import numpy as np
import pytest
import torch

from carpedeam_tpu import cli as jax_cli
from carpedeam_tpu_torch import _build, cli, utils, workload
from carpedeam_tpu_torch.io.seqdb import SeqDB
from torch_port_util import (contig_db, guided_world, same_outputs,
                             translate)

import chip_smoke

# subcommands that reach a device stage and take --device
DEVICE_CMDS = {"kmermatcher", "rescorediagonal", "ancient_correction",
               "ancient_read_assemble"}
# subcommands that take the assembly flags (params.add_flags)
FLAG_CMDS = DEVICE_CMDS | {"ancient_contig_merge", "guidedassembleresult"}
DAMAGE = ("--ancient-damage", "{d}/dmg_")

# (case, command, inputs, outputs, flags): inputs and outputs name files
# and DB prefixes in the chain's directory; each case reads what an
# earlier one wrote
CHAIN = [
    ("createdb", "createdb", ["reads.fa"], ["reads"], []),
    ("createdb-no-shuffle", "createdb", ["reads.fa"], ["reads_ns"],
     ["--shuffle", "0"]),
    ("mergereads", "mergereads", ["r1.fq", "r2.fq"], ["merged"], []),
    ("kmermatcher-reads", "kmermatcher", ["reads"], ["pref"],
     ["-k", "20", "--include-only-extendable", "0"]),
    ("rescorediagonal-reads", "rescorediagonal", ["reads", "pref"], ["aln"],
     []),
    ("ancient_correction-reads", "ancient_correction", ["reads", "aln"],
     ["corr"], list(DAMAGE)),
    ("ancient_read_assemble", "ancient_read_assemble", ["corr", "aln"],
     ["asm"], list(DAMAGE)),
    ("kmermatcher-assembled", "kmermatcher", ["asm"], ["pref2"], []),
    ("rescorediagonal-assembled", "rescorediagonal", ["asm", "pref2"],
     ["aln2"], []),
    ("ancient_contig_merge-assembled", "ancient_contig_merge",
     ["asm", "aln2"], ["cm"], list(DAMAGE)),
    ("createhdb", "createhdb", ["cm"], ["cm_h"], ["--cycle-keys", "{keys}"]),
    ("createhdb-no-cycles", "createhdb", ["cm"], ["cm_h0"], []),
    ("convert2fasta", "convert2fasta", ["cm_h"], ["cm.fa"], []),
    ("kmermatcher-contigs", "kmermatcher", ["contigs"], ["cpref"],
     ["--include-only-extendable", "0"]),
    ("rescorediagonal-contigs", "rescorediagonal", ["contigs", "cpref"],
     ["caln"], []),
    ("ancient_correction-contigs", "ancient_correction",
     ["contigs", "caln"], ["ccorr"],
     list(DAMAGE) + ["--min-seqid-corr-reads", "0.9"]),
    ("ancient_contig_merge-contigs", "ancient_contig_merge",
     ["ccorr", "caln"], ["ccm"], list(DAMAGE)),
    ("cyclecheck", "cyclecheck", ["cyc.fa"], ["cyc_out.fa"], []),
    ("cyclecheck-chop", "cyclecheck", ["cyc.fa"], ["cyc_chop.fa"],
     ["--chop-cycle", "1"]),
    ("guidedassembleresult", "guidedassembleresult",
     ["gnucl", "gaa", "galn"], ["gout_n", "gout_a"], []),
]
CASES = {c[0]: c for c in CHAIN}


def _argv(case, d_in, d_out, extra=()):
    _, command, ins, outs, flags = case
    keys = ",".join(str(k) for k in range(0, 400, 7))
    quiet = ["-v", "0"] if command in FLAG_CMDS else []
    return [command, *(os.path.join(d_in, f) for f in ins),
            *(os.path.join(d_out, f) for f in outs),
            *(f.format(d=d_in, keys=keys) for f in flags), *quiet, *extra]


def _cyclic_fasta(path, seed):
    """Sequences whose end repeats their start (circular contigs) among
    linear ones."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as fh:
        for i in range(12):
            s = "".join("ACGT"[b] for b in rng.integers(0, 4, 900))
            if i % 2 == 0:
                s = s + s[:int(rng.integers(100, 300))]
            fh.write(f">c{i}\n{s}\n")


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """The inputs, and the JAX CLI's run of the whole chain, in one
    directory."""
    d = str(tmp_path_factory.mktemp("chain"))
    db, rates = workload.generate(31, 2000)
    chip_smoke.write_fasta(db, os.path.join(d, "reads.fa"))
    chip_smoke.write_profiles(os.path.join(d, "dmg_"), *rates)
    chip_smoke.write_paired(db.select(np.arange(600)),
                            os.path.join(d, "r1.fq"),
                            os.path.join(d, "r2.fq"))
    contig_db(32, 120, 200, 1500, 20_000, sub_rate=0.001).save(
        os.path.join(d, "contigs"))
    _cyclic_fasta(os.path.join(d, "cyc.fa"), 33)
    seqs = guided_world(34, n=24)
    SeqDB.from_sequences(seqs).save(os.path.join(d, "gnucl"))
    SeqDB.from_sequences([translate(s) for s in seqs]).save(
        os.path.join(d, "gaa"))
    assert jax_cli.main(["kmermatcher", os.path.join(d, "gnucl"),
                         os.path.join(d, "gpref"), "-k", "20",
                         "--include-only-extendable", "0"]) == 0
    assert jax_cli.main(["rescorediagonal", os.path.join(d, "gnucl"),
                         os.path.join(d, "gpref"),
                         os.path.join(d, "galn")]) == 0
    for case in CHAIN:
        assert jax_cli.main(_argv(case, d, d)) == 0, case[0]

    def load(name):
        return SeqDB.load(os.path.join(d, name))
    # every stage changes its input: corrected bases, extended reads and
    # contigs, merged pairs
    assert not np.array_equal(load("corr").data, load("reads").data)
    assert not np.array_equal(load("ccorr").data, load("contigs").data)
    assert all(load(n).ext.sum() > 0 for n in ("asm", "cm", "ccm"))
    assert len(load("merged")) < 1200
    return d


def _run_port(chain, case_id, out_dir, extra=()):
    """The port's subcommand of `case_id` on the chain's inputs, into
    out_dir; returns a directory holding the JAX CLI's outputs of the
    case (FASTA, .npz, .headers) and nothing else, for same_outputs."""
    case = CASES[case_id]
    os.makedirs(out_dir, exist_ok=True)
    dev = ("--device", "cpu") if case[1] in DEVICE_CMDS else ()
    assert cli.main(_argv(case, chain, out_dir, (*dev, *extra))) == 0
    ref = out_dir + "_ref"
    os.makedirs(ref, exist_ok=True)
    for name in os.listdir(chain):
        if any(name in (o, o + ".npz", o + ".headers") for o in case[3]):
            os.link(os.path.join(chain, name), os.path.join(ref, name))
    return ref


@pytest.mark.parametrize("case_id", list(CASES))
def test_subcommand_output_equals_jax_cli(chain, tmp_path, case_id):
    out = str(tmp_path / "port")
    ref = _run_port(chain, case_id, out)
    assert same_outputs(out, ref) >= 1


@pytest.mark.parametrize("use_device", ["0", "1", "mesh"])
@pytest.mark.parametrize("case_id", ["rescorediagonal-reads",
                                     "rescorediagonal-contigs",
                                     "ancient_correction-reads",
                                     "ancient_correction-contigs",
                                     "ancient_read_assemble"])
def test_device_subcommands_under_use_device(chain, tmp_path, case_id,
                                             use_device):
    """--use-device 0 (the host oracles), 1 (the tensor programs) and mesh
    (the sharded stages) write the JAX CLI's bytes too."""
    out = str(tmp_path / "port")
    ref = _run_port(chain, case_id, out, ("--use-device", use_device))
    assert same_outputs(out, ref) >= 1


@pytest.mark.parametrize("case_id,stage", [
    ("rescorediagonal-reads", "rescorediagonal"),
    ("rescorediagonal-contigs", "rescorediagonal"),
    ("ancient_correction-reads", "correction"),
    ("ancient_read_assemble", "extension_scoring")])
def test_device_subcommands_run_records_on_the_device_path(
        chain, tmp_path, case_id, stage):
    """On the CPU the kernel route runs the kernels' plain versions: the
    stage's records go through the device path (coverage_summary), none
    through the host oracle, and no kernel launches; under --use-device
    0 no record takes the device path."""
    utils.coverage_reset()
    _build.reset_launch_counts()
    _run_port(chain, case_id, str(tmp_path / "auto"))
    cov = utils.coverage_summary()[stage]
    assert cov["device"] > 100 and cov["host"] == 0, cov
    assert all(n == 0 for n in _build.launch_counts().values())
    utils.coverage_reset()
    _run_port(chain, case_id, str(tmp_path / "host"), ("--use-device", "0"))
    assert utils.coverage_summary().get(stage, {"device": 0})["device"] == 0


@pytest.mark.parametrize("case_id", ["kmermatcher-reads",
                                     "rescorediagonal-reads",
                                     "ancient_correction-reads",
                                     "ancient_read_assemble"])
def test_device_subcommands_need_a_card_unless_asked_for_the_cpu(
        chain, tmp_path, monkeypatch, case_id):
    """--device cuda (the default) on a machine without a card raises; the
    subcommand does not carry on on the CPU and writes nothing.  The
    kmermatcher reads --device under CARPEDEAM_KMER_DEVICE=1."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("CARPEDEAM_KMER_DEVICE", "1")
    case = CASES[case_id]
    out = str(tmp_path / "port")
    os.makedirs(out)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(_argv(case, chain, out))
    assert os.listdir(out) == []


def test_device_kmermatcher_subcommand_equals_jax_cli(chain, tmp_path,
                                                      monkeypatch):
    """CARPEDEAM_KMER_DEVICE=1 runs the device kmermatcher (plain versions
    on the CPU), as in the pipeline: the JAX CLI's PrefDB."""
    monkeypatch.setenv("CARPEDEAM_KMER_DEVICE", "1")
    utils.coverage_reset()
    out = str(tmp_path / "port")
    ref = _run_port(chain, "kmermatcher-reads", out)
    assert same_outputs(out, ref) == 1
    assert utils.coverage_summary()["kmermatcher"]["device"] == 1


@pytest.mark.parametrize("command", list(dict.fromkeys(
    ["ancient_assemble", "nuclassemble"] + [c[1] for c in CHAIN])))
def test_help_lists_the_jax_positional_arguments(capsys, command):
    """`<command> -h` of both CLIs: the same positional arguments."""
    def positional(main):
        with pytest.raises(SystemExit):
            main([command, "-h"])
        text = capsys.readouterr().out
        return text.split("positional arguments:")[1].split("options:")[0]
    assert positional(cli.main) == positional(jax_cli.main)


def test_the_cli_lists_every_jax_command(capsys):
    def commands(main):
        with pytest.raises(SystemExit):
            main(["-h"])
        return capsys.readouterr().out.splitlines()[1].strip()
    assert commands(cli.main) == commands(jax_cli.main)


@pytest.mark.parametrize("argv", [
    ["rescorediagonal", "{d}/reads", "{d}/missing", "{t}/out"],
    ["ancient_read_assemble", "{d}/missing", "{d}/aln", "{t}/out"],
    ["createdb", "{d}/missing.fa", "{t}/out"],
    ["convert2fasta", "{d}/missing", "{t}/out.fa"],
    ["rescorediagonal", "{d}/reads", "{d}/pref", "{t}/out", "--min-seq-id",
     "2"],
    ["kmermatcher", "{d}/reads", "{t}/out", "-k", "40"],
], ids=["missing-pref", "missing-db", "missing-fasta", "missing-prefix",
        "bad-seq-id", "bad-k"])
def test_bad_parameter_or_missing_input_exits_1(chain, tmp_path, capsys,
                                                argv):
    """As the JAX CLI: one line on stderr, exit 1, no output written."""
    argv = [a.format(d=chain, t=tmp_path) for a in argv]
    assert jax_cli.main(argv) == 1
    capsys.readouterr()
    dev = ["--device", "cpu"] if argv[0] in DEVICE_CMDS else []
    assert cli.main([*argv, *dev]) == 1
    err = capsys.readouterr().err
    assert len(err.strip().splitlines()) == 1, err
    assert not any(n.startswith("out") for n in os.listdir(tmp_path))
