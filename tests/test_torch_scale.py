"""BASELINE.json config 3, the default pipeline on a 10-species mock
ancient community: the port's host route against the JAX package on a
20,000-read draw, and chip_smoke's `--scale` check rehearsed on the CPU
(each route in a child process) against the JAX package's hash."""
import argparse
import hashlib

import carpedeam_tpu.pipeline as JP
import chip_smoke
from carpedeam_tpu.params import add_flags as jax_add_flags
from carpedeam_tpu.params import params_from_args as jax_params_from_args
from carpedeam_tpu_torch import pipeline
from torch_port_util import damage_pair, to_jax_db


def _jax_fasta(db, rates, path) -> bytes:
    """The JAX package's ancient_assemble FASTA, --use-device 0, default
    flags."""
    jdm, _ = damage_pair(*rates)
    ap = argparse.ArgumentParser()
    jax_add_flags(ap)
    jp = jax_params_from_args(ap.parse_args(["--use-device", "0"]))
    JP.ancient_assemble(to_jax_db(db), jp, jdm, out_fasta=str(path))
    return path.read_bytes()


def test_config3_host_route_matches_jax(tmp_path):
    """20,000 reads of the config-3 community (seed 4, chip_smoke's
    --scale draw): the port's host route (`--use-device 0`) writes the JAX
    package's FASTA, with contigs in it."""
    db, rates = chip_smoke.scale_reads(20_000)
    ref = _jax_fasta(db, rates, tmp_path / "jax.fa")
    _, tdm = damage_pair(*rates)
    pipeline.ancient_assemble(db, chip_smoke.default_params("0"), tdm,
                              out_fasta=str(tmp_path / "port.fa"))
    assert ref.count(b">") >= 5
    assert (tmp_path / "port.fa").read_bytes() == ref


def test_scale_check_rehearsed_on_the_cpu(tmp_path, monkeypatch):
    """check_scale on 4,000 reads on the CPU: the kernel route (plain
    versions), the host route and the device kmermatcher route, each in a
    child process, write one FASTA, the JAX package's (its hash recorded
    for this N as the chip's 1M hash is), with every device stage's
    records on the CPU device path, and each route's peak RSS read."""
    n = 4000
    db, rates = chip_smoke.scale_reads(n)
    ref = hashlib.sha256(_jax_fasta(db, rates, tmp_path / "jax.fa")) \
        .hexdigest()
    monkeypatch.setitem(chip_smoke.JAX_FASTA_SHA256, n, ref)
    got = chip_smoke.check_scale(n, str(tmp_path), "cpu")
    assert got["jax_sha256"] == ref
    routes = got["routes"]
    assert set(routes) == {"kernel", "host", "kmer_device"}
    assert {r["fasta_sha256"] for r in routes.values()} == {ref}
    assert all(r["peak_rss_gib"] > 0 for r in routes.values())
    assert routes["kernel"]["coverage"]["correction"]["device"] > 0
    assert routes["host"]["coverage"] == {}
    assert len(routes["kernel"]["longest"]) == 10
    # the contig phase is told apart under the device kmermatcher too
    assert set(routes["kmer_device"]["levels"]["correction"]) \
        == {"read", "contig"}


def test_scale_phase_rehearsed_on_the_cpu(monkeypatch):
    """chip_smoke's phase `scale` at small shapes on the CPU: the plane
    derivation's spot check, each kernel's synthetic inputs from the
    seeded generator through its wrapper (the plain version here) against
    the chunked plain version (a few chunks), and the bytes and
    operations of its bound."""
    from carpedeam_tpu_torch.damage import DamageModel
    from carpedeam_tpu_torch.workload import profile_rates
    monkeypatch.setattr(chip_smoke, "PLAIN_CELLS", 1 << 15)
    calls = (("rescore_pairs", 128, 600, 2000),
             ("correction", 512, 2, 1000),
             ("window_identity", 128, 600, 2000),
             ("consensus_likelihood", 128, 600, 2000))
    got = chip_smoke.check_scale_kernels(
        DamageModel.from_rates(*profile_rates()), "cpu", calls)
    assert set(got["derive"]) == {"assemble_planes",
                                  "derive_corrected_planes"}
    assert got["derive"]["assemble_planes"]["shape"] == [1000, 512]
    rows = {r["name"]: r for r in got["kernel_rows"]}
    assert set(rows) == {c[0] for c in calls}
    assert rows["correction"]["case"] == "L=512 blocks=2 G=32 R=128"
    assert all(r["bytes"] > 0 and r["ops"] > 0 for r in rows.values())
