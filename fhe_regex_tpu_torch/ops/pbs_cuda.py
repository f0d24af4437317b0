"""The hand-written CUDA blind rotation (``csrc/blind_rotate.cu``).

The Hopper counterpart of ``fhe_regex_tpu/ops/pbs_pallas.py``'s fused
blind rotation (``blind_rotate_fused`` / ``_fused_blindrot_kernel``): the
whole n-step CMUX ladder for a batch, with the LUT selection and the
initial X^{-b~} rotation built on the device.

The library is compiled with ``nvcc`` for ``sm_90a`` at first use, into
``build/`` at the repository root, keyed by a hash of the sources, and bound
through ``ctypes`` (a plain C entry point, no PyTorch headers).  Nothing is
compiled or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from fhe_regex_tpu_torch.ops.pbs import blind_rotate
from fhe_regex_tpu_torch.params import Params

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
SOURCES = ("blind_rotate.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (put the CUDA toolkit's bin/ on PATH "
                       "or set CUDA_HOME); the CUDA kernels cannot be built")


def library_path() -> Path:
    """Where the build for the current sources lives."""
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libfheregex_cuda-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a build of the current sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.fhe_blind_rotate.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.fhe_blind_rotate.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def blind_rotate_fused(params: Params, bsk: torch.Tensor, luts: torch.Tensor,
                       lut_idx: torch.Tensor,
                       cts_ms: torch.Tensor) -> torch.Tensor:
    """[B, n+1] mod-switched cts -> [B, k+1, N] int32 accumulators.

    Same contract as ``ops.pbs.blind_rotate``: bsk [n, (k+1)l, k+1, N] int32,
    luts [L, N] int32, lut_idx [B] int32 with values in [0, L).  CPU tensors
    take that plain version; CUDA tensors launch the kernel (each call adds
    one to ``blind_rotate_fused.launches``).
    """
    if cts_ms.device.type == "cpu":
        return blind_rotate(params, bsk, luts, lut_idx, cts_ms)
    if cts_ms.device.type != "cuda":
        raise ValueError(f"no blind rotation kernel for {cts_ms.device}")
    k1 = params.glwe_dimension + 1
    N, n, l = params.polynomial_size, params.lwe_dimension, params.pbs_level
    if params.torus_bits != 32:
        raise ValueError("the CUDA blind rotation is 32-bit only")
    if N % 256 or N & (N - 1):
        raise ValueError(f"N={N}: the kernel needs a power of two >= 256")
    if params.pbs_base_log > 7 or params.pbs_base_log * l >= 32:
        raise ValueError("the kernel's int8 digits need base_log <= 7 and "
                         "base_log * level < 32")
    B = cts_ms.shape[0]
    if B < 1:
        raise ValueError("empty batch")
    dev = cts_ms.device
    _check("cts_ms", cts_ms, (B, n + 1), torch.int32, dev)
    _check("luts", luts, (luts.shape[0], N), torch.int32, dev)
    _check("lut_idx", lut_idx, (B,), torch.int32, dev)
    _check("bsk", bsk, (n, k1 * l, k1, N), torch.int32, dev)

    lib = _load()
    acc = torch.empty((B, k1, N), dtype=torch.int32, device=dev)
    digits = torch.empty((B, k1 * l, N), dtype=torch.int8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fhe_blind_rotate(
            cts_ms.data_ptr(), luts.data_ptr(), lut_idx.data_ptr(),
            bsk.data_ptr(), acc.data_ptr(), digits.data_ptr(),
            B, n, k1, N, l, params.pbs_base_log, stream)
    if err != 0:
        raise RuntimeError(f"fhe_blind_rotate failed: cudaError_t {err}")
    blind_rotate_fused.launches += 1
    return acc


blind_rotate_fused.launches = 0
