"""The port's rescorediagonal (carpedeam_tpu_torch.ops.rescore_cuda, plain
PyTorch version on the CPU) against the JAX package's Pallas rescoring
(interpret mode): identical AlnDB records and identical packed outputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carpedeam_tpu.kmer.matcher import kmermatcher as jax_kmermatcher
from carpedeam_tpu.ops.rescore_pallas import (_pair_block,
                                               rescore_pairs_pallas,
                                               rescorediagonal_pallas)
from carpedeam_tpu.ops.rescore_tpu import pack_sequences as jax_pack
from carpedeam_tpu_torch.kmer.matcher import kmermatcher
from carpedeam_tpu_torch.ops import rescore_cuda as R
from carpedeam_tpu_torch.ops.planes import device_planes
from carpedeam_tpu_torch.stages.rescorediagonal import rescorediagonal
from torch_port_util import contig_db, reads_world, to_jax_db


@pytest.fixture(scope="module")
def world():
    db, jdb, _, _ = reads_world(21, 1500)
    pref = kmermatcher(db, 20, 200, 0.2, False)
    jpref = jax_kmermatcher(jdb, 20, 200, 0.2, False)
    return db, jdb, pref, jpref


def test_host_kmermatcher_copy_matches_jax(world):
    _, _, pref, jpref = world
    assert pref.to_text() == jpref.to_text()


def test_rescorediagonal_matches_pallas(world):
    db, jdb, pref, jpref = world
    mine = R.rescorediagonal_cuda(db, pref, 0.9, device="cpu")
    ref = rescorediagonal_pallas(jdb, jpref, 0.9)
    assert len(mine.qkey) > 1000
    assert mine.to_text() == ref.to_text()
    assert mine.to_text() == rescorediagonal(db, pref, 0.9).to_text()


def test_rescorediagonal_with_shared_planes_and_long_levels():
    """Shared 512-wide planes serve the first level; longer pairs run in
    per-level planes (2048, 8192), and pairs past the last level take the
    host scorer — all identical to the host oracle."""
    db = contig_db(22, 40, 300, 2500, 12000)
    pref = kmermatcher(db, 22, 200, 0.2, False)
    longest = np.maximum(db.lengths[db.lookup_keys(pref.qkey)],
                         db.lengths[db.lookup_keys(pref.tkey)])
    assert (longest <= 512).any() and (longest > 2048).any()
    planes, lengths = device_planes(db, max_len=512, device="cpu")
    mine = R.rescorediagonal_cuda(db, pref, 0.9, planes=planes,
                                  lengths=lengths)
    assert mine.to_text() == rescorediagonal(db, pref, 0.9).to_text()


@pytest.mark.parametrize("width", [512, 2048])
def test_packed_outputs_match_rescore_pairs_pallas(width):
    db = contig_db(23 + width, 30, width // 4, width - 10, 6 * width)
    pref = kmermatcher(db, 22, 200, 0.2, False)
    planes, lengths = jax_pack(to_jax_db(db), max_len=width)
    n = len(pref.qkey)
    qidx = db.lookup_keys(pref.qkey).astype(np.int32)
    pairs = np.zeros((n, 3), np.int32)
    pairs[:, 0] = qidx | np.where(pref.score < 0, np.int32(-2147483648),
                                  np.int32(0))
    pairs[:, 1] = db.lookup_keys(pref.tkey)
    pairs[:, 2] = pref.diag
    B = _pair_block(width)
    padded = np.zeros((-(-n // B) * B, 3), np.int32)
    padded[:n] = pairs
    ref = np.asarray(rescore_pairs_pallas(
        jnp.asarray(planes["code"]), jnp.asarray(planes["sym"]),
        jnp.asarray(lengths), jnp.asarray(padded), max_len=width,
        interpret=True))[:n]
    mine = R.rescore_pairs(torch.from_numpy(planes["code"]),
                           torch.from_numpy(planes["sym"]),
                           torch.from_numpy(lengths),
                           torch.from_numpy(pairs))
    assert n > 50
    assert np.array_equal(mine.numpy(), ref)


@pytest.mark.parametrize("L", [8192, 16384])
def test_edge_pairs_at_the_top_levels_match_rescore_pairs_pallas(L):
    """chip_smoke's rescore edge pairs (rows as long as the plane and
    beyond it, reverse query rows, invalid and one-column candidates) at
    the ladder's top levels: the plain version equals the Pallas kernel.
    The generator's codes >= 4 become X (4), the only code past T that
    CHAR_TO_CODE gives a plane."""
    import chip_smoke
    code, sym, lens, pairs = chip_smoke._rescore_edges(
        np.random.default_rng(L), L, 8, 300, False, "cpu")
    code = torch.where(code >= 4, 4, code).to(torch.uint8).contiguous()
    P = pairs.shape[0]
    B = _pair_block(L)
    padded = np.zeros((-(-P // B) * B, 3), np.int32)
    padded[:P] = pairs.numpy()
    ref = np.asarray(rescore_pairs_pallas(
        jnp.asarray(code.numpy()), jnp.asarray(sym.numpy()),
        jnp.asarray(lens.numpy()), jnp.asarray(padded), max_len=L,
        interpret=True))[:P]
    mine = R.rescore_pairs(code, sym, lens, pairs)
    assert (ref[:, 0] & 0xFFFF).any() and (lens.numpy() > L).any()
    assert np.array_equal(mine.numpy(), ref)


def test_rescore_pairs_rejects_what_the_kernel_does_not_take():
    code = torch.zeros((4, 128), dtype=torch.uint8)
    lens = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        R.rescore_pairs(code, code, lens, torch.zeros((3, 3),
                                                      dtype=torch.int64))
    with pytest.raises(ValueError):
        R.rescore_pairs(code, code, lens, torch.zeros((3, 2),
                                                      dtype=torch.int32))
    with pytest.raises(ValueError):
        R.rescore_pairs(code, code[:, ::2], lens,
                        torch.zeros((3, 3), dtype=torch.int32))
