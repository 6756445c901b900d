"""Build and load the port's native libraries.

Two shared libraries, both built at first use into `build/torch_kernels/`
at the repository root (listed in .gitignore) and cached by a hash of
their source text and compile command:

* the CUDA kernels, `csrc/*.cu`, compiled by ONE `nvcc` call for
  `sm_90a` into a library with a plain C interface (no PyTorch headers),
  loaded with ctypes;
* the host C++ runtime (`native/*.cpp`, built by native/__init__.py
  through `build_shared_library`).

Each build runs under a timeout and raises on failure.  Concurrent
builders (test workers) each compile to a private temporary file and
rename it into place, so no lock file is needed.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass

_HERE = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(_HERE)
BUILD_DIR = os.path.join(REPO_ROOT, "build", "torch_kernels")
CSRC_DIR = os.path.join(_HERE, "csrc")
NVCC_TIMEOUT_S = 600
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


@dataclass(frozen=True)
class BuildResult:
    path: str
    seconds: float      # compile time of this call (0.0 when cached)
    cached: bool
    log: str = ""       # the compiler's stderr (ptxas register report)


def build_shared_library(name: str, sources: list[str], command,
                         timeout_s: float, hashed: list[str] | None = None
                         ) -> BuildResult:
    """Compile `sources` with `command(out_path)` into
    BUILD_DIR/<name>-<hash>.so unless that file exists.  `hashed` lists
    the files whose text keys the cache (default: `sources`)."""
    h = hashlib.sha256()
    for path in sorted(hashed or sources):
        with open(path, "rb") as fh:
            h.update(os.path.basename(path).encode() + b"\0" + fh.read())
    h.update(" ".join(command("OUT")).encode())
    out = os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return BuildResult(out, 0.0, True)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}.{threading.get_ident()}"
    cmd = command(tmp)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout_s)
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"build of {name} failed ({proc.returncode})"
                               f":\n{' '.join(cmd)}\n{proc.stderr[-4000:]}")
        os.replace(tmp, out)
    except FileNotFoundError as exc:
        raise RuntimeError(f"build of {name}: compiler not found "
                           f"({cmd[0]})") from exc
    except subprocess.TimeoutExpired as exc:
        raise RuntimeError(f"build of {name} exceeded {timeout_s} s") \
            from exc
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return BuildResult(out, secs, False, proc.stderr)


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, /usr/local/cuda or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def build_kernels() -> BuildResult:
    """One nvcc call over every csrc/*.cu into one sm_90a library."""
    cu = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    deps = cu + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    nvcc = nvcc_path()
    return build_shared_library(
        "carpedeam_kernels", cu,
        lambda out: [nvcc, *NVCC_FLAGS, *cu, "-o", out],
        timeout_s=NVCC_TIMEOUT_S, hashed=deps)


class CudaKernel:
    """One exported kernel entry point of the CUDA library, with its
    launch count (incremented by `launch`, and nowhere else)."""

    def __init__(self, name: str, symbol: str, argtypes: list,
                 source: str, replaces: str):
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self.source = source
        self.replaces = replaces
        self.launches = 0

    def launch(self, *args) -> None:
        fn = _cuda_lib()[self.symbol]
        rc = fn(*args)
        self.launches += 1
        if rc != 0:
            msg = _cuda_lib()["cd_error_string"](rc).decode()
            raise RuntimeError(f"{self.name}: launch failed ({rc}: {msg})")


_P = ctypes.c_void_p
_I = ctypes.c_int64

KERNELS = {
    k.name: k for k in (
        CudaKernel("rescore_pairs", "cd_rescore_pairs",
                   [_P, _P, _P, _P, _I, _I, _I, _P, _P],
                   "carpedeam_tpu_torch/csrc/rescore.cu",
                   "carpedeam_tpu/ops/rescore_pallas.py:80"),
        CudaKernel("correction", "cd_correction",
                   [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
                   "carpedeam_tpu_torch/csrc/correction.cu",
                   "carpedeam_tpu/ops/correction_pallas.py:99"),
        CudaKernel("window_identity", "cd_window_identity",
                   [_P, _I, _P, _P, _P, _I, _P, _P],
                   "carpedeam_tpu_torch/csrc/window.cu",
                   "carpedeam_tpu/ops/window_pallas.py:45"),
        CudaKernel("consensus_likelihood", "cd_consensus_likelihood",
                   [_P, _P, _I, _P, _P, _P, _I, _P, _P],
                   "carpedeam_tpu_torch/csrc/ext.cu",
                   "carpedeam_tpu/ops/ext_pallas.py:64"),
        CudaKernel("kmer_windows", "cd_kmer_windows",
                   [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
                   "carpedeam_tpu_torch/csrc/kmer_windows.cu",
                   "carpedeam_tpu/ops/kmer_tpu.py:121"),
        CudaKernel("kmer_select", "cd_kmer_select",
                   [_P, _P, _I, _I, _I, _I, ctypes.c_float, _P, _P],
                   "carpedeam_tpu_torch/csrc/kmer_select.cu",
                   "carpedeam_tpu/ops/kmer_tpu.py:190"),
        CudaKernel("seg_suffix_scan", "cd_seg_suffix_scan",
                   [_I, _P, _P, _P, _I, _P, _P, _P, _P],
                   "carpedeam_tpu_torch/csrc/seg_scan.cu",
                   "carpedeam_tpu/ops/kmer_tpu.py:404"),
    )
}

_LIB_LOCK = threading.Lock()
_LIB: dict | None = None


def _cuda_lib() -> dict:
    """symbol -> ctypes function of the built CUDA library."""
    global _LIB
    if _LIB is None:
        with _LIB_LOCK:
            if _LIB is None:
                lib = ctypes.CDLL(build_kernels().path)
                fns = {}
                for k in KERNELS.values():
                    fn = getattr(lib, k.symbol)
                    fn.argtypes = k.argtypes
                    fn.restype = ctypes.c_int
                    fns[k.symbol] = fn
                err = lib.cd_error_string
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                fns["cd_error_string"] = err
                _LIB = fns
    return _LIB


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}
