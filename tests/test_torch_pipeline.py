"""The whole slice: the port's ancient_assemble on the CPU (the kernels'
plain PyTorch versions) writes the same FASTA bytes as the JAX package,
against its host path over 10 iterations (safe and --unsafe) and against
its Pallas path (interpret mode) over a short run; plus the port's import
and device rules and its `--use-device` routing."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import carpedeam_tpu.pipeline as JP
from carpedeam_tpu_torch import _build, convert, pipeline, utils, workload
from carpedeam_tpu_torch.ops import (correction_cuda, ext_cuda, planes,
                                     rescore_cuda, window_cuda)
from carpedeam_tpu_torch.params import Params
from torch_port_util import params_pair, reads_world, same_seqs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("unsafe", [False, True], ids=["safe", "unsafe"])
def test_ancient_assemble_fasta_matches_jax_host_path(tmp_path, unsafe):
    db, jdb, jdm, tdm = reads_world(51, 3000)
    jp, tp = params_pair(use_device="0", ancient_unsafe=unsafe,
                         min_contig_len=100)
    JP.ancient_assemble(jdb, jp, jdm, out_fasta=str(tmp_path / "jax.fa"))
    # the port's kernel path ("auto"), on the CPU: the plain versions
    rep = pipeline.ancient_assemble(db, tp.copy(use_device="auto"), tdm,
                                    out_fasta=str(tmp_path / "port.fa"),
                                    device="cpu")
    assert len(rep) > 5
    ref = (tmp_path / "jax.fa").read_bytes()
    assert (tmp_path / "port.fa").read_bytes() == ref


def test_nuclassemble_matches_jax_pallas_path():
    db, jdb, jdm, tdm = reads_world(52, 1500)
    jp, tp = params_pair(use_device="pallas", num_iterations=4,
                         num_iterations_reads=2, min_contig_len=0)
    ref, ref_cyc, _ = JP.nuclassemble(jdb, jp, jdm)
    mine, cyc, _ = pipeline.nuclassemble(db, tp, tdm, device="cpu")
    assert len(mine) > 100
    assert cyc == ref_cyc
    assert same_seqs(mine, ref)


# the kernel wrappers and the plane upload: what the kernel path calls
# and the host oracles never do
_KERNEL_PATH = ((rescore_cuda, "rescore_pairs"),
                (correction_cuda, "correction_kernel"),
                (window_cuda, "window_identity"),
                (ext_cuda, "consensus_likelihood"),
                (planes, "PlanesPrefetch"))


def _count_kernel_path(monkeypatch, forbid: bool) -> dict:
    """Count the calls of every _KERNEL_PATH function (raise in each one
    instead when `forbid`)."""
    calls = {name: 0 for _, name in _KERNEL_PATH}
    for module, name in _KERNEL_PATH:
        fn = getattr(module, name)

        def counted(*args, _fn=fn, _name=name, **kw):
            if forbid:
                raise AssertionError(f"{_name} called")
            calls[_name] += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(module, name, counted)
    return calls


def test_use_device_0_runs_the_host_oracles_without_a_card(monkeypatch):
    """--use-device 0 runs the host oracles as the JAX package does: no
    planes, no kernel wrapper, no card (the default device "cuda" is not
    read), zero launches, no device record, the JAX package's result."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _count_kernel_path(monkeypatch, forbid=True)
    db, jdb, jdm, tdm = reads_world(59, 1500)
    jp, tp = params_pair(use_device="0", num_iterations=4,
                         num_iterations_reads=2, min_contig_len=0)
    _build.reset_launch_counts()
    utils.coverage_reset()
    mine, cyc, _ = pipeline.nuclassemble(db, tp, tdm)
    assert all(v == 0 for v in _build.launch_counts().values())
    assert all(d["device"] == 0 for d in utils.coverage_summary().values())
    ref, ref_cyc, _ = JP.nuclassemble(jdb, jp, jdm)
    assert len(mine) > 100
    assert cyc == ref_cyc
    assert same_seqs(mine, ref)


@pytest.mark.parametrize("use_device", ["auto", "pallas"])
def test_auto_and_pallas_run_the_kernel_path(monkeypatch, use_device):
    """--use-device auto and pallas go through every kernel wrapper (their
    plain versions on the CPU tensors of device="cpu"), and need a card
    unless the caller asks for the CPU."""
    calls = _count_kernel_path(monkeypatch, forbid=False)
    db, _, _, tdm = reads_world(60, 800)
    p = Params(use_device=use_device, num_iterations=3,
               num_iterations_reads=2, min_contig_len=0)
    out, _, _ = pipeline.nuclassemble(db, p, tdm, device="cpu")
    assert len(out) > 0
    assert all(n > 0 for n in calls.values()), calls
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        pipeline.nuclassemble(db, p, tdm)


@pytest.mark.parametrize("entry", ["nuclassemble", "ancient_assemble"])
def test_use_device_mesh_matches_jax_host_route(tmp_path, entry):
    """--use-device mesh (the sharded stages, on a one-device CPU mesh
    for device="cpu") gives each entry point the JAX host route's
    result."""
    db, jdb, jdm, tdm = reads_world(61, 1500)
    jp, tp = params_pair(use_device="0", num_iterations=2,
                         num_iterations_reads=1, min_contig_len=100)
    mesh = tp.copy(use_device="mesh")
    if entry == "nuclassemble":
        ref, ref_cyc, _ = JP.nuclassemble(jdb, jp, jdm)
        mine, cyc, _ = pipeline.nuclassemble(db, mesh, tdm, device="cpu")
        assert len(mine) > 10
        assert cyc == ref_cyc
        assert same_seqs(mine, ref)
    else:
        JP.ancient_assemble(jdb, jp, jdm, out_fasta=str(tmp_path / "j.fa"))
        rep = pipeline.ancient_assemble(db, mesh, tdm, device="cpu",
                                        out_fasta=str(tmp_path / "p.fa"))
        assert len(rep) > 3
        assert (tmp_path / "p.fa").read_bytes() == \
            (tmp_path / "j.fa").read_bytes()


def test_checkpoints_resume_to_the_same_result(tmp_path):
    db, _, _, tdm = reads_world(53, 800)
    p = Params(num_iterations=3, num_iterations_reads=2, min_contig_len=0)
    a, _, _ = pipeline.nuclassemble(db, p, tdm, tmp_dir=str(tmp_path),
                                    device="cpu")
    b, _, _ = pipeline.nuclassemble(db, p, tdm, tmp_dir=str(tmp_path),
                                    device="cpu")
    assert same_seqs(a, b)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "sys.path.insert(0, %r)\n"
        "import chip_smoke\n"
        "import carpedeam_tpu_torch.cli, carpedeam_tpu_torch.convert\n"
        "import carpedeam_tpu_torch.pipeline, carpedeam_tpu_torch.workload\n"
        "from carpedeam_tpu_torch.ops import (correction_cuda, ext_cuda,\n"
        "    extension_batch, planes, rescore_cuda, window_cuda)\n"
        "from carpedeam_tpu_torch.ops import (correction_device,\n"
        "    kmer_device, rescore_device)\n"
        "from carpedeam_tpu_torch.stages import linclust, mergereads\n"
        "from carpedeam_tpu_torch.parallel import (distributed, driver,\n"
        "    mesh)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'carpedeam_tpu' or m.startswith('carpedeam_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n") % REPO
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=REPO)
    assert res.returncode == 0, res.stdout + res.stderr


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    db, _, _, tdm = reads_world(54, 200)
    p = Params(num_iterations=1, num_iterations_reads=1, min_contig_len=0)
    with pytest.raises(RuntimeError, match="cuda"):
        pipeline.nuclassemble(db, p, tdm)
    with pytest.raises(RuntimeError, match="cuda"):
        pipeline.ancient_assemble(db, p, tdm, device="cuda")
    out, _, _ = pipeline.nuclassemble(db, p, tdm, device="cpu")
    assert len(out) > 0


def test_cli_runs_on_the_cpu(tmp_path):
    db, _, _, _ = reads_world(55, 600)
    fq = tmp_path / "reads.fa"
    with open(fq, "w") as fh:
        for i in range(len(db)):
            fh.write(f">r{i}\n{db.seq_str(i)}\n")
    out = tmp_path / "out.fa"
    from carpedeam_tpu_torch import cli
    rc = cli.main(["nuclassemble", str(fq), str(out), str(tmp_path / "tmp"),
                   "--device", "cpu", "--num-iterations", "2",
                   "--num-iter-reads-only", "1", "--min-contig-len", "1",
                   "-v", "0"])
    assert rc == 0 and out.read_bytes().startswith(b">0 len:")


@pytest.mark.parametrize("case", ["bad-parameter", "missing-input"])
def test_cli_errors_exit_as_the_jax_cli_does(tmp_path, capsys, case):
    """A flag value params_from_args rejects, and a reads file that does
    not exist: both CLIs exit 1 with the same one-line message after
    their program name."""
    from carpedeam_tpu import cli as jax_cli
    from carpedeam_tpu_torch import cli
    reads = tmp_path / "reads.fa"
    if case == "bad-parameter":
        reads.write_text(">r0\nACGTACGTAC\n")
        extra = ["--num-iterations", "0"]
    else:
        reads = tmp_path / "missing.fq"
        extra = []
    argv = ["ancient_assemble", str(reads), str(tmp_path / "o.fa"),
            str(tmp_path / "t"), *extra]
    codes, msgs = [], []
    for prog, main, more in (("carpedeam-tpu", jax_cli.main, []),
                             ("carpedeam-tpu-torch", cli.main,
                              ["--device", "cpu"])):
        codes.append(main(argv + more))
        err = capsys.readouterr().err.strip().splitlines()
        assert len(err) == 1 and err[0].startswith(prog + ": "), err
        msgs.append(err[0][len(prog) + 2:])
    assert codes == [1, 1]
    assert msgs[0] == msgs[1]
    assert msgs[0].startswith("invalid parameter: --num-iterations"
                              if case == "bad-parameter"
                              else "input not found: ")


def test_convert_from_reference_round_trip_and_checks():
    _, (s5, s3) = workload.generate(56, 10)
    from carpedeam_tpu.damage import DamageModel as JaxDamageModel
    from carpedeam_tpu.params import Params as JaxParams
    jdm = JaxDamageModel.from_rates(s5, s3)
    arrays = convert.state_arrays(jdm)
    jp = JaxParams(ancient_unsafe=True, explicit=frozenset({"ancient_unsafe"}))
    dm, p = convert.from_reference(arrays, dataclasses.asdict(jp))
    for k in ("fwd", "rev", "fwd_ld", "rev_ld", "sub5p", "sub3p"):
        assert np.array_equal(getattr(dm, k), getattr(jdm, k)), k
        assert getattr(dm, k).dtype == getattr(jdm, k).dtype, k
    assert dataclasses.asdict(p) == dataclasses.asdict(jp)
    assert p.copy_defaults(ancient_unsafe=False).ancient_unsafe
    bad = dict(arrays, wtab=arrays["wtab"] + 1)
    with pytest.raises(ValueError, match="wtab"):
        convert.from_reference(bad, {})
    with pytest.raises(ValueError, match="fwd"):
        convert.from_reference({k: v for k, v in arrays.items()
                                if k != "fwd"}, {})


def test_workload_is_seeded_and_shaped_like_the_reference_example():
    a, rates = workload.generate(57, 5000)
    b, _ = workload.generate(57, 5000)
    assert np.array_equal(a.data, b.data)
    assert a.lengths.min() >= 35 and a.lengths.max() <= 120
    assert 45 < a.lengths.mean() < 57
    assert rates[0].shape == (len(workload.CT5), 12)
    # 5' terminal C->T damage is visible: T is enriched at position 0
    first = a.data[a.offsets]
    assert (first == ord("T")).mean() > (first == ord("C")).mean()
