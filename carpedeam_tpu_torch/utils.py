"""Shared runtime utilities: shape bucketing, device choice, stage
timing, device-coverage counters, logging.

Plane widths round up to LEN_BUCKET multiples (the same length levels as
the JAX package, so both route the same records to the same kernels).
"""
from __future__ import annotations

import os
import time

import torch


def bucket(n: int, q: int) -> int:
    """Round n up to a multiple of q (minimum q)."""
    return max(q, ((int(n) + q - 1) // q) * q)


LEN_BUCKET = int(os.environ.get("CARPEDEAM_LEN_BUCKET", 128))


def bucket_len(n: int) -> int:
    return bucket(n, LEN_BUCKET)


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Raises when CUDA is asked for and no card is present (there
    is no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' requested but no CUDA device "
                               "is available; pass device='cpu' to run "
                               "the plain PyTorch versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


class StageTimer:
    """Wall-clock per-stage timing (the reference's Timer/Debug::Progress
    analogue, lib/mmseqs/src/commons/Timer.h).  Collects (stage, seconds)
    and prints through the supplied logger when verbose."""

    def __init__(self, log=None):
        self.records: list[tuple[str, float]] = []
        self._log = log

    def time(self, name: str):
        return _StageScope(self, name)

    def add(self, name: str, secs: float) -> None:
        self.records.append((name, secs))
        if self._log:
            self._log(f"{name}: {secs:.3f}s{_rss_suffix()}")

    def summary(self) -> dict:
        out: dict[str, float] = {}
        for name, secs in self.records:
            out[name] = out.get(name, 0.0) + secs
        return out


def _rss_suffix() -> str:
    """' [rss now/peak GB]' for stage logs — the footprint attribution
    the reference gets from its 1-byte-per-residue design doc
    (README.md:89-91); /proc is Linux-only, degrade to empty."""
    try:
        with open("/proc/self/status") as fh:
            txt = fh.read()
        now = int(txt.split("VmRSS:")[1].split()[0]) / 1e6
        peak = int(txt.split("VmHWM:")[1].split()[0]) / 1e6
        return f"  [rss {now:.1f}/{peak:.1f} GB]"
    except Exception:
        return ""


class _StageScope:
    def __init__(self, timer: StageTimer, name: str):
        self.timer, self.name = timer, name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.timer.add(self.name, time.perf_counter() - self.t0)
        return False


# --------------------------------------------------------------------------
# Sub-step profiling: fine-grained host-prep / H2D / device / D2H / host-
# assembly attribution inside the device stages.  Enabled with
# CARPEDEAM_SUBTIMING=1; prints "## <stage>.<step>: <secs>" to stderr and
# accumulates into SUBTIMES for programmatic reads (tools/profile_fine.py).
# --------------------------------------------------------------------------
_SUBTIMING = os.environ.get("CARPEDEAM_SUBTIMING", "") not in ("", "0")
SUBTIMES: dict[str, float] = {}


class _SubScope:
    __slots__ = ("name", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        SUBTIMES[self.name] = SUBTIMES.get(self.name, 0.0) + dt
        import sys
        print(f"## {self.name}: {dt:.4f}s", file=sys.stderr, flush=True)
        return False


class _NullScope:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SCOPE = _NullScope()


def subtimer(name: str):
    """Context manager timing one sub-step when CARPEDEAM_SUBTIMING=1
    (no-op otherwise; the hot path pays one truthiness check)."""
    return _SubScope(name) if _SUBTIMING else _NULL_SCOPE


# --------------------------------------------------------------------------
# Device-coverage accounting: per stage, how many records ran on the
# device kernels vs through the exact host oracles (length-ladder
# overflows, non-ACGT chars, deep stacks).  Aggregated per run so the
# SCALE/PERF artifacts can report "N% of records on device" as a
# measured number per stage rather than a log line.
# --------------------------------------------------------------------------
DEVICE_COVERAGE: dict[str, dict[str, int]] = {}


def coverage_add(stage: str, device_n: int, host_n: int) -> None:
    d = DEVICE_COVERAGE.setdefault(stage, {"device": 0, "host": 0})
    d["device"] += int(device_n)
    d["host"] += int(host_n)


def coverage_reset() -> None:
    DEVICE_COVERAGE.clear()


def coverage_summary() -> dict[str, dict]:
    out = {}
    for stage, d in DEVICE_COVERAGE.items():
        total = d["device"] + d["host"]
        out[stage] = {**d, "total": total,
                      "device_pct": round(100.0 * d["device"] / total, 2)
                      if total else None}
    return out


# --------------------------------------------------------------------------
# Verbosity-levelled logging (the reference's Debug class,
# lib/mmseqs/src/commons/Debug.h:20-160).  Levels: 0 NOTHING, 1 ERROR,
# 2 WARNING, 3 INFO (reference default).
# --------------------------------------------------------------------------
INFO_LVL = 3
_VERBOSITY = INFO_LVL


def set_verbosity(level: int) -> None:
    global _VERBOSITY
    _VERBOSITY = int(level)


def log_info(msg: str) -> None:
    if _VERBOSITY >= INFO_LVL:
        print(msg, flush=True)
