"""kerasify-format MLP loader and forward pass (the Plass coding filter).

The reference bundles serialized Keras MLPs (data/predict_coding_*.model,
kerasify binary format) that Plass's `filternoncoding` uses to score
protein fragments for coding potential; the capability is compiled into
the CarpeDeam binary but not registered in its command table
(lib/kerasify/keras_model.{h,cpp}).  The port's counterpart of
carpedeam_tpu/ops/coding_mlp.py: the same loader, and the forward pass as
an `nn.Sequential` of float32 `nn.Linear` layers and activation modules
on the card (or the CPU when the caller asks for it).

Format (little-endian; keras_model.cpp:18-64,632-660):
  uint32 num_layers; per layer: uint32 layer_type; Dense(1): uint32 rows,
  cols, bias_n, float32 weights[rows*cols], float32 biases[bias_n],
  uint32 activation; Flatten(3): nothing; ELU(4): float32 alpha;
  Activation(5): uint32 activation.

Layers apply in file order, as kerasify's KerasModel::Apply does.  Two
differences from the JAX package's forward_fn, which applies every
standalone Activation layer after all Dense layers and reads no alpha for
ELU (dropping ELU and Flatten in the forward pass): the port follows
kerasify in both (ROADMAP Queue 3).  Where the two agree (Dense layers
with their built-in activation, then at most trailing Activation layers,
the shape of the bundled predict_coding models) the outputs are equal.
"""
from __future__ import annotations

import struct

import numpy as np
import torch
from torch import nn

from ..utils import resolve_device

_DENSE = 1
_FLATTEN = 3
_ELU = 4
_ACTIVATION = 5

_ACT_LINEAR, _ACT_RELU, _ACT_SOFTPLUS, _ACT_SIGMOID, _ACT_TANH, \
    _ACT_HARD_SIGMOID = 1, 2, 3, 4, 5, 6


class _Softplus(nn.Module):
    """log1p(exp(x)), kerasify's softplus (no overflow guard, as the JAX
    package's)."""

    def forward(self, x):
        return torch.log1p(torch.exp(x))


class _HardSigmoid(nn.Module):
    """clip(0.2 x + 0.5, 0, 1), Keras's hard sigmoid (torch's
    nn.Hardsigmoid uses x / 6 + 0.5)."""

    def forward(self, x):
        return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


def _activation(code: int) -> nn.Module:
    if code == _ACT_RELU:
        return nn.ReLU()
    if code == _ACT_SOFTPLUS:
        return _Softplus()
    if code == _ACT_SIGMOID:
        return nn.Sigmoid()
    if code == _ACT_TANH:
        return nn.Tanh()
    if code == _ACT_HARD_SIGMOID:
        return _HardSigmoid()
    if code == _ACT_LINEAR:
        return nn.Identity()
    raise NotImplementedError(f"kerasify activation {code}")


class KerasifyModel:
    """Layers in file order: ("dense", W (in, out) f32, b (out,) f32,
    activation), ("act", activation), ("flatten",), ("elu", alpha)."""

    def __init__(self, layers):
        self.layers = layers

    @staticmethod
    def load(path: str) -> "KerasifyModel":
        with open(path, "rb") as fh:
            data = fh.read()
        off = 0

        def u32():
            nonlocal off
            (v,) = struct.unpack_from("<I", data, off)
            off += 4
            return v

        def floats(n):
            nonlocal off
            v = np.frombuffer(data, dtype="<f4", count=n, offset=off).copy()
            off += 4 * n
            return v

        layers = []
        for _ in range(u32()):
            lt = u32()
            if lt == _DENSE:
                rows, cols, bn = u32(), u32(), u32()
                w = floats(rows * cols).reshape(rows, cols)
                b = floats(bn)
                layers.append(("dense", w, b, u32()))
            elif lt == _ACTIVATION:
                layers.append(("act", u32()))
            elif lt == _FLATTEN:
                layers.append(("flatten",))
            elif lt == _ELU:
                layers.append(("elu", float(floats(1)[0])))
            else:
                raise NotImplementedError(f"kerasify layer type {lt}")
        return KerasifyModel(layers)

    def module(self, device="cuda") -> nn.Sequential:
        """The forward pass, f(x: (B, in_dim) float32) -> (B, out_dim), on
        `device` (raises without a card unless it is the CPU)."""
        mods: list[nn.Module] = []
        for kind, *rest in self.layers:
            if kind == "dense":
                w, b, act = rest
                lin = nn.Linear(w.shape[0], w.shape[1], dtype=torch.float32)
                with torch.no_grad():
                    lin.weight.copy_(torch.from_numpy(np.ascontiguousarray(
                        w.T, dtype=np.float32)))
                    lin.bias.copy_(torch.from_numpy(
                        np.asarray(b, dtype=np.float32)))
                mods += [lin, _activation(act)]
            elif kind == "act":
                mods.append(_activation(rest[0]))
            elif kind == "elu":
                mods.append(nn.ELU(alpha=rest[0]))
            else:                       # flatten: identity on (B, in_dim)
                mods.append(nn.Identity())
        return nn.Sequential(*mods).to(resolve_device(device)).eval()


def coding_scores(model_path: str, features: np.ndarray,
                  device="cuda") -> np.ndarray:
    """Score (B, in_dim) feature rows with a kerasify model; float32."""
    dev = resolve_device(device)
    net = KerasifyModel.load(model_path).module(dev)
    x = torch.as_tensor(np.asarray(features, dtype=np.float32)).to(dev)
    with torch.no_grad():
        return net(x).cpu().numpy()
