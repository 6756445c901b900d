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


def _rows_of_every_length(seed: int, n: int, L: int):
    """(N, L) forward symbol rows of random lengths, among them rows of
    length 0, L, longer than L (truncated to the plane, as the shared
    planes hold contigs past 512) and lengths that are no multiple of
    16, with N, IUPAC and lowercase characters."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 2 * L, n)
    lens[:6] = (0, L, L + 37, 17, L - 1, 1)
    chars = np.frombuffer(b"ACGTACGTACGTNRYacgt", np.uint8)
    sym = chars[rng.integers(0, len(chars), (n, L))]
    sym[np.arange(L)[None, :] >= lens[:, None]] = 0
    return sym, lens.astype(np.int32)


@pytest.mark.parametrize("cells", [1, 3 * 48 + 5, 10 * 48])
def test_chunked_planes_match_jax_and_one_pass(monkeypatch, cells):
    """The derivation in row chunks (one row, three rows and a bit, ten
    rows a pass) equals the JAX package's _assemble_planes and the same
    derivation in one pass, bit for bit."""
    sym, lens = _rows_of_every_length(11, 37, 48)
    t_sym, t_len = torch.from_numpy(sym), torch.from_numpy(lens)
    whole = P.assemble_planes(t_sym, t_len)
    monkeypatch.setattr(P, "DERIVE_CELLS", cells)
    assert len(P.row_chunks(37, 48)) > 1
    got = P.assemble_planes(t_sym, t_len)
    ref = _assemble_planes(jnp.asarray(sym), jnp.asarray(lens))
    for k in ("code", "sym", "len"):
        assert np.array_equal(got[k].numpy(), np.asarray(ref[k])), k
        assert torch.equal(got[k], whole[k]), k


@pytest.mark.parametrize("cells", [1, 5 * 64 + 9])
def test_chunked_corrected_planes_match_jax_and_one_pass(monkeypatch,
                                                         cells):
    """derive_corrected_planes in row chunks equals the JAX package's
    _derive_corrected_planes and its own one-pass form, with sequences
    that have no slot (src < 0) and rows of length 0, L, past L and no
    multiple of 16."""
    sym, lens = _rows_of_every_length(12, 41, 64)
    rng = np.random.default_rng(4)
    t_len = torch.from_numpy(lens)
    planes = P.assemble_planes(torch.from_numpy(sym), t_len)
    packed = rng.integers(0, 256, (12, 64)).astype(np.uint8)
    src = rng.integers(-1, 12 * 4, len(lens)).astype(np.int32)
    src[:3] = (-1, 0, 12 * 4 - 1)
    args = (planes["sym"], t_len, torch.from_numpy(packed),
            torch.from_numpy(src))
    whole = derive_corrected_planes(*args)
    monkeypatch.setattr(P, "DERIVE_CELLS", cells)
    got = derive_corrected_planes(*args)
    ref = _derive_corrected_planes(jnp.asarray(planes["sym"].numpy()),
                                   jnp.asarray(lens),
                                   jnp.asarray(packed.view(np.int8)),
                                   jnp.asarray(src))
    for k in ("code", "sym", "len"):
        assert np.array_equal(got[k].numpy(), np.asarray(ref[k])), k
        assert torch.equal(got[k], whole[k]), k


def test_row_chunks_cover_every_row_once(monkeypatch):
    assert P.row_chunks(0, 8) == []
    assert P.row_chunks(5, 8) == [(0, 5)]
    monkeypatch.setattr(P, "DERIVE_CELLS", 9)
    assert P.row_chunks(10, 4) == [(0, 2), (2, 4), (4, 6), (6, 8), (8, 10)]
    assert P.row_chunks(3, 100) == [(0, 1), (1, 2), (2, 3)]
