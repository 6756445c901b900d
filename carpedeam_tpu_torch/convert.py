"""Carry the run state across from the JAX package.

The port has no weights.  Its state is the damage model's tables, the
tables the kernels read, and the run parameters:

* `fwd`, `rev`: (11, 4, 4) float64 damage tensors p[layer, qbase, tbase];
* `fwd_ld`, `rev_ld`: their 80-bit long-double twins (extension scoring);
* `sub5p`, `sub3p` (optional): the raw (rows, 12) profile rates;
* `wtab` (optional): the correction kernel's (48, 16) float32 table;
* `logm` (optional): the consensus kernel's (11, 16) float32 table;
* `params`: the Params fields as a dict.

`from_reference` builds the port's DamageModel and Params from those
arrays, so both packages compute from the same numbers; the optional
kernel tables are checked against the ones the port derives.

The one model with weights is the kerasify coding MLP:
`kerasify_layers_from_jax` carries the JAX package's
`KerasifyModel.layers` (numpy weights and biases, activation codes, in
file order) across into the port's `ops.coding_mlp.KerasifyModel`.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .damage import DamageModel, seq_error_profile_ld
from .ops.correction_cuda import correction_wtab
from .ops.likelihood import likelihood_table
from .params import Params

_TENSOR_KEYS = ("fwd", "rev", "fwd_ld", "rev_ld")


def consensus_logm(damage: DamageModel) -> np.ndarray:
    """(11, 16) float32 table of the consensus kernel, [layer, 4*qb+tb]:
    the read-phase extension's likelihood table (80-bit damage tensor,
    sequencing error 0.001) rounded to f32."""
    deam = damage.fwd_ld if damage.fwd_ld is not None else damage.fwd
    logm = likelihood_table(deam, seq_error_profile_ld(0.001))
    return np.asarray(logm, dtype=np.float32).reshape(11, 16)


def state_arrays(damage: DamageModel) -> dict[str, np.ndarray]:
    """The arrays `from_reference` takes, from a DamageModel."""
    return {"fwd": damage.fwd, "rev": damage.rev, "fwd_ld": damage.fwd_ld,
            "rev_ld": damage.rev_ld, "sub5p": damage.sub5p,
            "sub3p": damage.sub3p, "wtab": correction_wtab(damage),
            "logm": consensus_logm(damage)}


def from_reference(arrays: dict[str, np.ndarray], params: dict
                   ) -> tuple[DamageModel, Params]:
    """(DamageModel, Params) of the port from the reference's arrays and
    parameter dict.  Raises ValueError on a missing or misshapen array,
    or when a given kernel table differs from the derived one."""
    for k in _TENSOR_KEYS:
        if k not in arrays:
            raise ValueError(f"missing array {k!r}")
        if np.shape(arrays[k]) != (11, 4, 4):
            raise ValueError(f"{k} must be (11, 4, 4), got "
                             f"{np.shape(arrays[k])}")
    empty = np.zeros((0, 12), dtype=np.float64)
    damage = DamageModel(
        fwd=np.asarray(arrays["fwd"], dtype=np.float64),
        rev=np.asarray(arrays["rev"], dtype=np.float64),
        sub5p=np.asarray(arrays.get("sub5p", empty), dtype=np.float64),
        sub3p=np.asarray(arrays.get("sub3p", empty), dtype=np.float64),
        fwd_ld=np.asarray(arrays["fwd_ld"], dtype=np.longdouble),
        rev_ld=np.asarray(arrays["rev_ld"], dtype=np.longdouble))
    for key, derived in (("wtab", correction_wtab), ("logm", consensus_logm)):
        if key in arrays and not np.array_equal(
                np.asarray(arrays[key], dtype=np.float32), derived(damage)):
            raise ValueError(f"{key} differs from the table derived from "
                             f"the damage tensors")
    fields = {f.name for f in dataclasses.fields(Params)}
    unknown = set(params) - fields
    if unknown:
        raise ValueError(f"unknown Params fields: {sorted(unknown)}")
    kw = dict(params)
    if "explicit" in kw:
        kw["explicit"] = frozenset(kw["explicit"])
    return damage, Params(**kw)


def kerasify_layers_from_jax(layers) -> list:
    """The port's kerasify layer list from the JAX package's
    `KerasifyModel.layers`: ("dense", W, b, act), ("act", act),
    ("flatten",) and ("elu", alpha) in file order; weights and biases
    copied as float32.  Raises ValueError on an unknown layer or a dense
    layer whose shapes disagree."""
    out = []
    for kind, *rest in layers:
        if kind == "dense":
            w, b, act = rest
            w = np.array(w, dtype=np.float32)
            b = np.array(b, dtype=np.float32)
            if w.ndim != 2 or b.shape != (w.shape[1],):
                raise ValueError(f"dense layer W {w.shape}, b {b.shape}")
            out.append(("dense", w, b, int(act)))
        elif kind == "act":
            out.append(("act", int(rest[0])))
        elif kind == "elu":
            out.append(("elu", float(rest[0])))
        elif kind == "flatten":
            out.append(("flatten",))
        else:
            raise ValueError(f"unknown kerasify layer {kind!r}")
    return out
