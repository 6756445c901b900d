"""The port's multi-process and sharded paths (carpedeam_tpu_torch/
parallel/) against the JAX package's on the CPU: the partition helpers,
the hash-sharded and the two-process kmermatcher, range rescoring, the
mesh-sharded rescore and correction over [cpu] * k, the device k-mer
sort, the f32 e-value, and the pipeline and CLI forms (`--use-device
mesh`, CARPEDEAM_RANK/WORLD with and without CARPEDEAM_COORD, `--world`),
each ending in the JAX package's FASTA.  Every comparison is exact but
the f32 e-value's (relative 1e-5)."""
import functools
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import carpedeam_tpu.parallel.distributed as JD
import carpedeam_tpu.parallel.mesh as JMESH
import carpedeam_tpu.pipeline as JP
from carpedeam_tpu import cli as jax_cli
from carpedeam_tpu.aligndb import PrefDB as JaxPrefDB
from carpedeam_tpu.kmer import matcher as JK
from carpedeam_tpu.ops.rescore_tpu import evalue_device as jax_evalue
from carpedeam_tpu_torch import pipeline, workload
from carpedeam_tpu_torch.aligndb import PrefDB
from carpedeam_tpu_torch.kmer.matcher import (BIT63,
                                              extract_selected_kmers_batched,
                                              kmermatcher,
                                              sort_kmer_entries_device)
from carpedeam_tpu_torch.ops.rescore_device import evalue_device
from carpedeam_tpu_torch.parallel import distributed as D
from carpedeam_tpu_torch.parallel import mesh as M
from carpedeam_tpu_torch.stages.correction import correction
from carpedeam_tpu_torch.stages.rescorediagonal import rescorediagonal
from torch_port_util import (contig_db, params_pair, reads_world, same_seqs,
                             to_jax_db)

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROC_TIMEOUT_S = 120
# the suite runs several workers on the same cores: a rank subprocess
# takes two threads
RANK_ENV = {**os.environ, "OMP_NUM_THREADS": "2"}
RANK_ENV.pop("PYTHONPATH", None)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _to_jax_pref(pref: PrefDB) -> JaxPrefDB:
    return JaxPrefDB(pref.qkey, pref.tkey, pref.score, pref.diag,
                     pref.starts, pref.qkeys, pref.qext)


def _same_pref(a, b) -> bool:
    return all(np.array_equal(getattr(a, f), getattr(b, f))
               for f in ("qkey", "tkey", "score", "diag", "starts", "qkeys"))


# ---- partition helpers -----------------------------------------------------
_LENS = np.random.default_rng(3).integers(30, 400, 257)


@pytest.mark.parametrize("name, args", [
    ("kmer_hash_ranges", (1,)), ("kmer_hash_ranges", (7,)),
    ("shards_for_process", (5, 0, 2)), ("shards_for_process", (7, 2, 3)),
    ("decompose_by_residue_count", (_LENS, 3)),
    ("decompose_by_residue_count", (_LENS[:2], 5)),
    ("_contiguous_partition", (_LENS, 4)),
    ("_contiguous_partition", (np.zeros(9, np.int64), 3)),
], ids=lambda v: v if isinstance(v, str) else "")
def test_partition_helpers_match_jax(name, args):
    mine = getattr(M if name == "kmer_hash_ranges" else D, name)(*args)
    ref = getattr(JMESH if name == "kmer_hash_ranges" else JD, name)(*args)
    assert mine == ref


# ---- kmermatcher -----------------------------------------------------------
@pytest.mark.parametrize("n_shards", [2, 5])
def test_kmermatcher_sharded_matches_jax(n_shards):
    db, jdb, _, _ = reads_world(80, 1200)
    mine = D.kmermatcher_sharded(db, 20, 200, 0.2, False, n_shards=n_shards)
    assert _same_pref(mine, kmermatcher(db, 20, 200, 0.2, False))
    ref = JD.kmermatcher_sharded(jdb, 20, 200, 0.2, False,
                                 n_shards=n_shards)
    assert _same_pref(mine, ref)


def test_rescorediagonal_ranges_merge_to_the_full_stage():
    db, _, _, _ = reads_world(81, 1200)
    pref = kmermatcher(db, 20, 200, 0.2, False)
    full = rescorediagonal(db, pref, 0.9)
    qlens = db.lengths[db.lookup_keys(pref.qkeys)]
    ranges = D.decompose_by_residue_count(qlens, 3)
    parts = [D.rescorediagonal_range(db, pref, 0.9, rg) for rg in ranges
             if rg[0] < rg[1]]
    assert len(parts) == 3
    assert D.merge_aln_ranges(parts).to_text() == full.to_text()


_KM_WORKER = r"""
import os, sys
from carpedeam_tpu_torch.io.seqdb import SeqDB
from carpedeam_tpu_torch.parallel import distributed as D
from carpedeam_tpu_torch.parallel.driver import DistContext
rank, mode, d = int(sys.argv[1]), sys.argv[2], sys.argv[3]
db = SeqDB.load(os.path.join(d, "reads"))
if mode == "gloo":
    D.initialize("127.0.0.1:" + sys.argv[4], 2, rank)
    barrier = D.process_barrier
else:
    barrier = DistContext(rank, 2, os.path.join(d, "sync")).barrier
out = D.process_kmermatcher(db, (20, 200, 0.2, False, 67),
                            os.path.join(d, "shards"), rank, 2,
                            barrier=barrier, local=mode == "gloo")
if mode == "gloo":
    pref, (lo, hi) = out
    print("range", lo, hi)
else:
    pref = out
pref.save(os.path.join(d, f"pref_{rank}"))
"""


@pytest.mark.parametrize("mode", ["filesystem", "gloo"])
def test_process_kmermatcher_two_ranks(tmp_path, mode):
    """Two rank processes: with the filesystem barrier each returns the
    full PrefDB (local=False), equal to JAX kmermatcher's; over gloo each
    returns its centre span (local=True), and the spans cover every
    query group exactly once, each group equal to JAX's."""
    db, jdb, _, _ = reads_world(82, 1200)
    db.save(str(tmp_path / "reads"))
    args = [str(tmp_path)] + ([str(_free_port())] if mode == "gloo" else [])
    procs = [subprocess.Popen(
        [sys.executable, "-c", _KM_WORKER, str(r), mode, *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=RANK_ENV, cwd=REPO) for r in range(2)]
    outs = [p.communicate(timeout=PROC_TIMEOUT_S)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    ref = JK.kmermatcher(jdb, 20, 200, 0.2, False)
    prefs = [PrefDB.load(str(tmp_path / f"pref_{r}")) for r in range(2)]
    if mode == "filesystem":
        assert all(_same_pref(p, ref) for p in prefs)
        return
    spans = [tuple(int(x) for x in o.split("range")[1].split()[:2])
             for o in outs]
    assert spans[0][0] == 0 and spans[0][1] == spans[1][0] \
        and spans[1][1] == len(db) and spans[0][1] > 0
    merged = {}
    for p in prefs:
        text = p.to_text()
        assert not set(text) & set(merged)
        merged.update(text)
    assert merged == ref.to_text()


# ---- mesh-sharded stages ---------------------------------------------------
@functools.lru_cache(maxsize=None)
def _stage_world(kind: str):
    """(port DB, port PrefDB, damage, seq_id, JAX sharded AlnDB, JAX
    sharded corrected DB) of a read-like or a contig-like DB (lengths
    200-1500, over the 512-wide shared planes)."""
    _, _, jdm, tdm = reads_world(83, 50)
    if kind == "reads":
        db = reads_world(84, 1500)[0]
        pref = kmermatcher(db, 20, 200, 0.2, False)
        seq_id = 0.9
    else:
        db = contig_db(85, 250, 200, 1500, 30000)
        pref = kmermatcher(db, 22, 200, 0.2, True)
        seq_id = 0.97
    mesh8 = JMESH.make_mesh(8)
    jdb = to_jax_db(db)
    jaln = JMESH.rescorediagonal_sharded(mesh8)(jdb, _to_jax_pref(pref),
                                                seq_id)
    jcorr = JMESH.correction_sharded(mesh8)(jdb, jaln, jdm, 0.99, seq_id)
    return db, pref, tdm, seq_id, jaln, jcorr


@pytest.mark.parametrize("kind", ["reads", "contigs"])
@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("stage", ["rescore", "correction"])
def test_sharded_stages_match_jax(kind, k, stage):
    db, pref, tdm, seq_id, jaln, jcorr = _stage_world(kind)
    mesh = M.make_mesh(["cpu"] * k)
    aln = rescorediagonal(db, pref, seq_id)
    if stage == "rescore":
        mine = M.rescorediagonal_sharded(mesh)(db, pref, seq_id)
        assert len(mine) > len(db)
        assert mine.to_text() == jaln.to_text() == aln.to_text()
    else:
        mine = M.correction_sharded(mesh)(db, aln, tdm, 0.99, seq_id)
        host = correction(db, aln, tdm, 0.99, seq_id)
        assert np.array_equal(mine.data, host.data)
        assert np.array_equal(mine.data, jcorr.data)
        assert np.array_equal(mine.lengths, jcorr.lengths)
        assert (mine.data != db.data).any()


def test_make_mesh_needs_a_card_unless_given_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        M.make_mesh()
    with pytest.raises(RuntimeError, match="cuda"):
        M.make_mesh(["cuda:0"])
    assert M.make_mesh(["cpu", "cpu"]) == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError):
        M.make_mesh([])


def test_a_rank_that_asks_for_the_card_needs_one(monkeypatch):
    """Under --device cuda a rank raises without a card (no CPU in its
    place); under --device cpu it runs on the CPU."""
    from carpedeam_tpu_torch import cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cli._rank_device("cuda", 1)
    assert cli._rank_device("cpu", 1) == "cpu"


def test_sort_kmer_entries_device_matches_lexsort_and_jax():
    db, jdb, _, _ = reads_world(86, 800)
    ent = extract_selected_kmers_batched(db, 20, 200, 0.2, 67)
    host = np.lexsort((ent["pos"], ent["id"],
                       -ent["seq_len"].astype(np.int64),
                       ent["kmer"] | BIT63))
    mine = sort_kmer_entries_device(ent, "cpu")
    assert len(mine) > 10000
    assert np.array_equal(mine, host)
    jent = JK.extract_selected_kmers_batched(jdb, 20, 200, 0.2, 67)
    assert np.array_equal(mine, JK.sort_kmer_entries_device(jent))


@pytest.mark.parametrize("flush", [False, True],
                         ids=["normal", "flush-subnormals"])
def test_evalue_device_matches_jax(flush):
    """f32 e-values within relative 1e-5 of the JAX function's.  XLA's
    CPU backend flushes subnormal floats to zero and torch keeps them, so
    scores whose exp(-lambda*score) is subnormal (over ~137) are compared
    with torch flushing too; below that both keep every value normal."""
    rng = np.random.default_rng(87)
    hi = 400 if flush else 130
    score = rng.integers(0, hi, 5000)
    qlen = rng.integers(30, 5000, 5000)
    old = torch.is_flush_denormal() if hasattr(torch, "is_flush_denormal") \
        else False
    torch.set_flush_denormal(flush)
    try:
        mine = evalue_device(torch.from_numpy(score), torch.from_numpy(qlen),
                             6_000_000).numpy()
    finally:
        torch.set_flush_denormal(old)
    ref = np.asarray(jax_evalue(score, qlen, 6_000_000))
    assert mine.dtype == ref.dtype == np.float32
    np.testing.assert_allclose(mine, ref, rtol=1e-5, atol=0)


# ---- pipeline and CLI ------------------------------------------------------
def test_nuclassemble_mesh_of_three_matches_jax_host_route():
    db, jdb, jdm, tdm = reads_world(88, 1500)
    jp, tp = params_pair(use_device="0", num_iterations=2,
                         num_iterations_reads=1, min_contig_len=0)
    ref, ref_cyc, _ = JP.nuclassemble(jdb, jp, jdm)
    mine, cyc, _ = pipeline.nuclassemble(
        db, tp.copy(use_device="mesh"), tdm, device="cpu",
        mesh_devices=["cpu"] * 3)
    assert len(mine) > 100
    assert cyc == ref_cyc
    assert same_seqs(mine, ref)


def _cli_input(d, seed: int):
    """Reads FASTA, damage profiles and the JAX CLI's FASTA of them."""
    db, rates = workload.generate(seed, 1000)
    with open(d / "reads.fa", "w") as fh:
        for i in range(len(db)):
            fh.write(f">r{i}\n{db.seq_str(i)}\n")
    chip_smoke.write_profiles(str(d / "dmg_"), *rates)
    flags = ["--ancient-damage", str(d / "dmg_"), "--min-contig-len", "100",
             "-v", "0"]
    assert jax_cli.main(["ancient_assemble", str(d / "reads.fa"),
                         str(d / "jax.fa"), str(d / "jt"), *flags]) == 0
    ref = (d / "jax.fa").read_bytes()
    assert ref.count(b">") >= 3
    return d, flags, ref


@pytest.fixture(scope="module")
def cli_world(tmp_path_factory):
    return _cli_input(tmp_path_factory.mktemp("cli"), 89)


@pytest.fixture(scope="module")
def cli_world_b(tmp_path_factory):
    return _cli_input(tmp_path_factory.mktemp("cli_b"), 91)


def _port_cli(d, tag, flags, extra=(), tmp=None):
    return [sys.executable, "-m", "carpedeam_tpu_torch.cli",
            "ancient_assemble", str(d / "reads.fa"), str(d / f"{tag}.fa"),
            str(tmp or d / f"t_{tag}"), "--device", "cpu", *flags, *extra]


def _run_ranks(cmd, extra_env=None):
    """Two processes of `cmd` started with CARPEDEAM_RANK/WORLD; their
    outputs, after both exited 0."""
    procs = [subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO, env={**RANK_ENV, **(extra_env or {}),
                       "CARPEDEAM_RANK": str(r), "CARPEDEAM_WORLD": "2"})
        for r in range(2)]
    outs = [p.communicate(timeout=PROC_TIMEOUT_S)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    return outs


@pytest.mark.parametrize("coord", [False, True],
                         ids=["filesystem-barrier", "gloo-barrier"])
def test_cli_ranks_match_jax(cli_world, coord):
    """Two processes started with CARPEDEAM_RANK/WORLD (and
    CARPEDEAM_COORD for the torch.distributed barrier) write the JAX
    package's FASTA; the rank that is not 0 writes none."""
    d, flags, ref = cli_world
    tag = f"ranks_{int(coord)}"
    extra = {"CARPEDEAM_COORD": f"127.0.0.1:{_free_port()}"} if coord \
        else {}
    outs = _run_ranks(_port_cli(d, tag, flags), extra)
    assert "rank 1: done" in outs[1]
    assert (d / f"{tag}.fa").read_bytes() == ref


@pytest.mark.parametrize("command", ["ancient_assemble", "nuclassemble"])
def test_cli_world_matches_jax(cli_world, command):
    """`--world 2` writes the JAX CLI's FASTA; for nuclassemble too,
    whose ranks join the group where the JAX CLI's run whole and
    alone."""
    d, flags, ref = cli_world
    if command == "nuclassemble":
        assert jax_cli.main([command, str(d / "reads.fa"),
                             str(d / "jax_nucl.fa"), str(d / "jt_nucl"),
                             *flags]) == 0
        ref = (d / "jax_nucl.fa").read_bytes()
        assert ref.count(b">") >= 3
    cmd = _port_cli(d, f"world_{command}", flags, ["--world", "2"])
    cmd[cmd.index("ancient_assemble")] = command
    res = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO,
                         env=RANK_ENV, timeout=PROC_TIMEOUT_S)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "rank 1: done" in res.stdout
    assert (d / f"world_{command}.fa").read_bytes() == ref


def test_cli_world_fails_as_a_group_on_a_missing_input(tmp_path):
    """Both ranks fail (exit 1, the message of a missing input); the
    launcher takes the group down and exits non-zero."""
    res = subprocess.run(
        [sys.executable, "-m", "carpedeam_tpu_torch.cli", "ancient_assemble",
         str(tmp_path / "missing.fq"), str(tmp_path / "o.fa"),
         str(tmp_path / "t"), "--device", "cpu", "--world", "2"],
        capture_output=True, text=True, cwd=REPO, env=RANK_ENV,
        timeout=PROC_TIMEOUT_S)
    assert res.returncode != 0
    assert "input not found" in res.stderr
    assert "group terminated" in res.stderr
    assert not (tmp_path / "o.fa").exists()


@pytest.mark.parametrize("form", ["world", "ranks-filesystem"])
def test_cli_group_reruns_in_one_tmp_dir_on_another_input(
        cli_world, cli_world_b, tmp_path, form):
    """Two group runs on two inputs, one TMP_DIR: the second reads none
    of the barrier markers or spill files the first left there, and
    each writes its own input's JAX FASTA."""
    for d, flags, ref in (cli_world, cli_world_b):
        cmd = _port_cli(d, f"rerun_{form}", flags, tmp=tmp_path)
        if form == "world":
            res = subprocess.run(cmd + ["--world", "2"], capture_output=True,
                                 text=True, cwd=REPO, env=RANK_ENV,
                                 timeout=PROC_TIMEOUT_S)
            assert res.returncode == 0, res.stdout + res.stderr
        else:
            _run_ranks(cmd)
        assert (d / f"rerun_{form}.fa").read_bytes() == ref


def test_file_session_leaves_what_an_earlier_run_left(tmp_path):
    """Without a coordinator the ranks agree on a fresh run directory,
    even when a crashed run left its join nonce, session, run directory
    and barrier markers behind; rank 0 alone then cannot pass a barrier
    on the markers the crashed run wrote."""
    import threading
    import time

    from carpedeam_tpu_torch.parallel import driver
    dist_dir = tmp_path / "dist"
    (dist_dir / "old").mkdir(parents=True)
    for r in range(2):
        (dist_dir / "old" / f"barrier_1.{r}").touch()
    (dist_dir / "join.1").write_text("old1")
    (dist_dir / "session").write_text("old old1")
    (dist_dir / "ack.1").write_text("old")
    tokens = {}

    def rank(r, delay):
        time.sleep(delay)
        tokens[r] = driver._file_session(str(dist_dir), r, 2, timeout=30)

    threads = [threading.Thread(target=rank, args=(0, 0.0)),
               threading.Thread(target=rank, args=(1, 0.3))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert tokens[0] == tokens[1] != "old"
    assert not (dist_dir / "old").exists()
    ctx = driver.DistContext(0, 2, str(dist_dir / tokens[0]))
    with pytest.raises(TimeoutError):
        ctx.barrier(timeout=0.2)


def test_a_rank_meshes_over_its_own_device(monkeypatch, tmp_path):
    """Under `dist` with --use-device mesh and no device list, a rank
    shards over its own device, not over every card."""
    from carpedeam_tpu_torch.parallel import driver
    seen = []

    def make_mesh(devices=None):
        seen.append(devices)
        raise RuntimeError("mesh built")

    monkeypatch.setattr(M, "make_mesh", make_mesh)
    db, _, _, tdm = reads_world(91, 50)
    _, tp = params_pair(use_device="mesh")
    dist = driver.DistContext(1, 2, str(tmp_path / "dist"))
    with pytest.raises(RuntimeError, match="mesh built"):
        pipeline.nuclassemble(db, tp, tdm, tmp_dir=str(tmp_path),
                              device="cuda:1", dist=dist)
    assert seen == [["cuda:1"]]
