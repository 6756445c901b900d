"""The kerasify coding MLP in the port (ops/coding_mlp.py) against the JAX
package's KerasifyModel.forward_fn and against a NumPy forward pass in
kerasify's layer order, on model files written here (widths 57x32x64x1,
the shape of the bundled predict_coding_acc9743_57x32x64) and the LCG
feature rows of tests/test_coding_mlp.py.  Tolerance: rtol 2e-5, atol
2e-6, the JAX test's own."""
import numpy as np
import pytest
import torch

from carpedeam_tpu.ops.coding_mlp import KerasifyModel as JaxKerasifyModel
from carpedeam_tpu_torch import convert
from carpedeam_tpu_torch.ops.coding_mlp import KerasifyModel, coding_scores

from chip_smoke import write_kerasify
from test_coding_mlp import _lcg_features

RTOL, ATOL = 2e-5, 2e-6
LINEAR, RELU, SOFTPLUS, SIGMOID, TANH, HARD_SIGMOID = 1, 2, 3, 4, 5, 6


def dense(rng, n_in, n_out, act):
    w = rng.normal(0.0, 1.0 / np.sqrt(n_in), (n_in, n_out)).astype(np.float32)
    b = rng.normal(0.0, 0.1, n_out).astype(np.float32)
    return ("dense", w, b, act)


def numpy_forward(layers, x):
    """kerasify's KerasModel::Apply: every layer in file order, float64."""
    def act(v, code):
        return {LINEAR: lambda: v, RELU: lambda: np.maximum(v, 0.0),
                SOFTPLUS: lambda: np.log1p(np.exp(v)),
                SIGMOID: lambda: 1.0 / (1.0 + np.exp(-v)),
                TANH: lambda: np.tanh(v),
                HARD_SIGMOID: lambda: np.clip(0.2 * v + 0.5, 0.0, 1.0)}[code]()
    y = x.astype(np.float64)
    for kind, *rest in layers:
        if kind == "dense":
            w, b, code = rest
            y = act(y @ w.astype(np.float64) + b, code)
        elif kind == "act":
            y = act(y, rest[0])
        elif kind == "elu":
            y = np.where(y > 0, y, rest[0] * np.expm1(y))
    return y


def predict_coding_layers(seed, hidden=RELU, out=SIGMOID, trailing=()):
    """57x32x64x1 Dense layers, then the given trailing Activation
    layers."""
    rng = np.random.default_rng(seed)
    return [dense(rng, 57, 32, hidden), dense(rng, 32, 64, hidden),
            dense(rng, 64, 1, out)] + [("act", a) for a in trailing]


def port_forward(model, x):
    with torch.no_grad():
        return model.module("cpu")(torch.from_numpy(x)).numpy()


@pytest.fixture(scope="module")
def features():
    return _lcg_features(64, 57)


@pytest.mark.parametrize("hidden", [LINEAR, RELU, SOFTPLUS, SIGMOID, TANH,
                                    HARD_SIGMOID])
def test_dense_model_matches_jax_forward(tmp_path, features, hidden):
    """Dense layers with their built-in activation and a trailing
    Activation layer (where the two packages agree): the port equals
    forward_fn, loaded from the file and carried across through
    convert.kerasify_layers_from_jax."""
    layers = predict_coding_layers(hidden, hidden=hidden, out=LINEAR,
                                   trailing=(hidden,))
    path = str(tmp_path / "m.model")
    write_kerasify(path, layers)
    jm = JaxKerasifyModel.load(path)
    ref = np.asarray(jm.forward_fn()(features))
    mine = port_forward(KerasifyModel.load(path), features)
    assert mine.shape == ref.shape == (64, 1)
    np.testing.assert_allclose(mine, ref, rtol=RTOL, atol=ATOL)
    carried = KerasifyModel(convert.kerasify_layers_from_jax(jm.layers))
    np.testing.assert_allclose(port_forward(carried, features), ref,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(mine, numpy_forward(layers, features),
                               rtol=RTOL, atol=ATOL)


def test_loader_shapes_and_coding_scores(tmp_path, features):
    """The loader reads the predict_coding widths; coding_scores on the
    CPU equals forward_fn."""
    path = str(tmp_path / "m.model")
    write_kerasify(path, predict_coding_layers(3))
    km = KerasifyModel.load(path)
    assert [w.shape for (k, w, *_) in km.layers if k == "dense"] == \
        [(57, 32), (32, 64), (64, 1)]
    ref = np.asarray(JaxKerasifyModel.load(path).forward_fn()(features))
    got = coding_scores(path, features, device="cpu")
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    assert ((got > 0) & (got < 1)).all()


def test_coding_scores_needs_a_card_unless_asked_for_the_cpu(
        tmp_path, features, monkeypatch):
    path = str(tmp_path / "m.model")
    write_kerasify(path, predict_coding_layers(4))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        coding_scores(path, features)


def test_interleaved_activation_follows_kerasify_order(tmp_path, features):
    """Dense(linear) -> Activation(relu) -> Dense -> ...: the port applies
    the relu between the two Dense layers, as kerasify does; the JAX
    package's forward_fn applies it after the last one (ROADMAP Queue 3,
    fault (a)) and gives another result."""
    rng = np.random.default_rng(8)
    layers = [dense(rng, 57, 32, LINEAR), ("act", RELU),
              dense(rng, 32, 64, TANH), ("flatten",),
              dense(rng, 64, 1, LINEAR)]
    path = str(tmp_path / "m.model")
    write_kerasify(path, layers)
    want = numpy_forward(layers, features)
    np.testing.assert_allclose(port_forward(KerasifyModel.load(path),
                                            features), want,
                               rtol=RTOL, atol=ATOL)
    jax_out = np.asarray(JaxKerasifyModel.load(path).forward_fn()(features))
    assert not np.allclose(jax_out, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("alpha", [1.0, 0.3])
def test_elu_layer_reads_its_alpha(tmp_path, features, alpha):
    """An ELU layer carries one float32 alpha after its type; the port
    reads it and applies ELU in file order.  The JAX loader reads no
    alpha (ROADMAP Queue 3, fault (b)), so the float's bits become the
    next layer type and loading fails."""
    rng = np.random.default_rng(9)
    layers = [dense(rng, 57, 32, LINEAR), ("elu", alpha),
              dense(rng, 32, 64, LINEAR), ("elu", alpha),
              dense(rng, 64, 1, SIGMOID)]
    path = str(tmp_path / "m.model")
    write_kerasify(path, layers)
    km = KerasifyModel.load(path)
    assert [l[1] for l in km.layers if l[0] == "elu"] == \
        [np.float32(alpha)] * 2
    np.testing.assert_allclose(port_forward(km, features),
                               numpy_forward(layers, features),
                               rtol=RTOL, atol=ATOL)
    with pytest.raises(NotImplementedError):
        JaxKerasifyModel.load(path)
