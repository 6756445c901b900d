"""The port's device planes (carpedeam_tpu_torch.ops.planes) against the
JAX package's plane builders (carpedeam_tpu.ops.rescore_tpu): byte-equal
code, sym and len planes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carpedeam_tpu.ops.correction_pallas import _derive_corrected_planes
from carpedeam_tpu.ops.rescore_tpu import _assemble_planes
from carpedeam_tpu.ops.rescore_tpu import pack_sequences as jax_pack
from carpedeam_tpu_torch.ops import planes as P
from carpedeam_tpu_torch.ops.correction_cuda import derive_corrected_planes
from torch_port_util import contig_db, reads_world, to_jax_db


def _with_odd_chars(db, seed):
    """Copy of db with N, IUPAC and lowercase characters sprinkled in."""
    rng = np.random.default_rng(seed)
    data = db.data.copy()
    hit = rng.random(len(data)) < 0.01
    data[hit] = rng.choice(np.frombuffer(b"NRYKMnacgt", np.uint8),
                           int(hit.sum()))
    return type(db).from_flat(data, db.lengths, keys=db.keys, ext=db.ext)


@pytest.mark.parametrize("width,source", [(128, "reads"), (512, "contigs")])
def test_planes_match_jax(width, source):
    if source == "reads":
        db = reads_world(5, 600)[0]
    else:
        db = contig_db(5, 60, 100, 500, 5000)
    db = _with_odd_chars(db, width)
    planes, lengths = P.device_planes(db, max_len=width, device="cpu")
    fwd, jlen = jax_pack(to_jax_db(db), max_len=width, fwd_only=True)
    ref = _assemble_planes(jnp.asarray(fwd["sym"]), jnp.asarray(jlen))
    assert np.array_equal(lengths, jlen)
    for k in ("code", "sym", "len"):
        assert planes[k].dtype == (torch.int32 if k == "len"
                                   else torch.uint8), k
        assert np.array_equal(planes[k].numpy(), np.asarray(ref[k])), k


def test_host_pack_matches_jax():
    db = _with_odd_chars(reads_world(6, 300)[0], 1)
    ids = np.arange(0, len(db), 3)
    mine, lm = P.pack_sequences(db, max_len=128, ids=ids)
    ref, lr = jax_pack(to_jax_db(db), max_len=128, ids=ids)
    assert np.array_equal(lm, lr)
    for k in ("code", "sym"):
        assert np.array_equal(mine[k], ref[k]), k


def test_prefetch_matches_host_pack_planes():
    """Derived planes equal the host pack's stacked planes (the NumPy
    oracle of the derivation)."""
    db = reads_world(7, 300)[0]
    pf = P.PlanesPrefetch(db, max_len=128, device="cpu")
    planes, lengths = pf.get()
    host, hl = P.pack_sequences(db, max_len=128)
    assert np.array_equal(lengths, hl)
    for k in ("code", "sym"):
        assert np.array_equal(planes[k].numpy(), host[k]), k


def test_derived_corrected_planes_match_jax():
    db = reads_world(8, 200)[0]
    planes, lengths = P.device_planes(db, max_len=128, device="cpu")
    rng = np.random.default_rng(3)
    packed = rng.integers(0, 256, (48, 128)).astype(np.uint8)
    src = rng.integers(-1, 48 * 4, len(db)).astype(np.int32)
    mine = derive_corrected_planes(planes["sym"], planes["len"],
                                   torch.from_numpy(packed),
                                   torch.from_numpy(src))
    ref = _derive_corrected_planes(jnp.asarray(planes["sym"].numpy()),
                                   jnp.asarray(lengths),
                                   jnp.asarray(packed.view(np.int8)),
                                   jnp.asarray(src))
    for k in ("code", "sym", "len"):
        assert np.array_equal(mine[k].numpy(), np.asarray(ref[k])), k
