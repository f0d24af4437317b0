"""The hand-written CUDA blind rotations (``csrc/*.cu``).

The Hopper counterparts of ``fhe_regex_tpu/ops/pbs_pallas.py``'s fused
blind rotations: the whole n-step CMUX ladder for a batch, with the LUT
selection and the initial X^{-b~} rotation built on the device.

  ``blind_rotate_fused``      32-bit, ``csrc/blind_rotate.cu``
                              (``_fused_blindrot_kernel``)
  ``blind_rotate_fused64``    64-bit, ``csrc/blind_rotate64.cu``
                              (``_fused_blindrot64_stacked_kernel`` /
                              ``_fused_blindrot64_kernel``)
  ``blind_rotate_fused64_bg`` 64-bit over batch blocks, same source
                              (``_fused_blindrot64_bg_kernel``)

The library is compiled with ``nvcc`` for ``sm_90a`` at first use, into
``build/`` at the repository root, keyed by a hash of the sources (one
``nvcc`` per source, all at once, then one link), and bound through
``ctypes`` (plain C entry points, no PyTorch headers).  Nothing is compiled
or loaded when this module is imported.
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
from fhe_regex_tpu_torch.ops.pbs64 import blind_rotate64
from fhe_regex_tpu_torch.params import Params

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
SOURCES = ("blind_rotate.cu", "blind_rotate64.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

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
    """Compile the kernels unless a build of the current sources exists:
    every source at once into an object file, then one shared library."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    tmp = BUILD_DIR / f"{out.stem}.{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    objs = [tmp / f"{Path(s).stem}.o" for s in SOURCES]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o),
                               str(CSRC / s)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for s, o in zip(SOURCES, objs)]
    errs = [proc.communicate()[1] for proc in procs]
    for s, proc, err in zip(SOURCES, procs, errs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {s} ({proc.returncode}):\n"
                               f"{err}")
    lib = tmp / out.name
    res = subprocess.run([nvcc, "-shared", "-o", str(lib),
                          *(str(o) for o in objs)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                           f"{res.stderr}")
    os.replace(lib, out)
    shutil.rmtree(tmp, ignore_errors=True)
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.fhe_blind_rotate.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.fhe_blind_rotate.restype = ctypes.c_int
        lib.fhe_blind_rotate64.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.fhe_blind_rotate64.restype = ctypes.c_int
        lib.fhe_blind_rotate64_bg.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.fhe_blind_rotate64_bg.restype = ctypes.c_int
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


# ---------------- 64-bit torus ----------------


def _bg_block(B: int, cap: int = 512) -> "int | None":
    """Largest tb <= cap with B % tb == 0 and tb % 8 == 0; None if none
    (the JAX package's ``_bg_block``, with its 64-bit cap of 512)."""
    for tb in range(min(cap, B), 7, -8):
        if B % tb == 0:
            return tb
    return None


def _check_bg_tb(B: int, tb: int) -> None:
    """An explicit batch block must cover the batch exactly."""
    if tb <= 0 or tb % 8 != 0 or B % tb != 0 or tb > B:
        raise ValueError(
            f"batch block tb={tb} invalid for B={B}: need 8 | tb, "
            f"tb | B, 0 < tb <= B (every block must cover the batch "
            f"exactly — a remainder would be silently dropped)")


def _check64(params: Params, bsk, luts, lut_idx, cts_ms) -> None:
    k1 = params.glwe_dimension + 1
    N, n, l = params.polynomial_size, params.lwe_dimension, params.pbs_level
    if params.torus_bits != 64:
        raise ValueError("the 64-bit blind rotation needs a 64-bit set")
    if N % 256 or N & (N - 1):
        raise ValueError(f"N={N}: the kernel needs a power of two >= 256")
    if 64 - params.pbs_base_log * l < 33:
        raise ValueError("the kernel's int32 digits need base_log * level "
                         "<= 31")
    B = cts_ms.shape[0]
    if B < 1:
        raise ValueError("empty batch")
    dev = cts_ms.device
    _check("cts_ms", cts_ms, (B, n + 1), torch.int32, dev)
    _check("luts", luts, (luts.shape[0], N), torch.int64, dev)
    _check("lut_idx", lut_idx, (B,), torch.int32, dev)
    _check("bsk", bsk, (n, k1 * l, k1, N), torch.int64, dev)


def _launch64(entry: str, params: Params, bsk, luts, lut_idx, cts_ms,
              tb: "int | None") -> torch.Tensor:
    k1 = params.glwe_dimension + 1
    N, n, l = params.polynomial_size, params.lwe_dimension, params.pbs_level
    B = cts_ms.shape[0]
    dev = cts_ms.device
    lib = _load()
    acc = torch.empty((B, k1, N), dtype=torch.int64, device=dev)
    digits = torch.empty((tb or B, k1 * l, N), dtype=torch.int32, device=dev)
    blocks = () if tb is None else (tb,)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, entry)(
            cts_ms.data_ptr(), luts.data_ptr(), lut_idx.data_ptr(),
            bsk.data_ptr(), acc.data_ptr(), digits.data_ptr(),
            B, *blocks, n, k1, N, l, params.pbs_base_log, stream)
    if err != 0:
        raise RuntimeError(f"{entry} failed: cudaError_t {err}")
    return acc


def blind_rotate_fused64(params: Params, bsk: torch.Tensor,
                         luts: torch.Tensor, lut_idx: torch.Tensor,
                         cts_ms: torch.Tensor) -> torch.Tensor:
    """[B, n+1] mod-switched cts -> [B, k+1, N] int64 accumulators.

    Same contract as ``ops.pbs64.blind_rotate64``: bsk [n, (k+1)l, k+1, N]
    int64, luts [L, N] int64, lut_idx [B] int32 with values in [0, L),
    cts_ms [B, n+1] int32.  CPU tensors take that plain version; CUDA
    tensors launch the kernel (each call adds one to
    ``blind_rotate_fused64.launches``).
    """
    if cts_ms.device.type == "cpu":
        return blind_rotate64(params, bsk, luts, lut_idx, cts_ms)
    if cts_ms.device.type != "cuda":
        raise ValueError(f"no blind rotation kernel for {cts_ms.device}")
    _check64(params, bsk, luts, lut_idx, cts_ms)
    acc = _launch64("fhe_blind_rotate64", params, bsk, luts, lut_idx,
                    cts_ms, None)
    blind_rotate_fused64.launches += 1
    return acc


blind_rotate_fused64.launches = 0


def blind_rotate_fused64_bg(params: Params, bsk_rounded: torch.Tensor,
                            luts: torch.Tensor, lut_idx: torch.Tensor,
                            cts_ms: torch.Tensor,
                            tb: "int | None" = None) -> torch.Tensor:
    """``blind_rotate_fused64`` over batch blocks of ``tb`` instances, each
    block running its whole rotation, on a key rounded by
    ``pbs64.round_bsk64`` (the JAX ``pallas64-bg`` backend).

    ``tb=None`` takes the largest 8-aligned divisor of B up to 512; a B
    with none, or an explicit ``tb`` that does not cover B exactly, raises
    ValueError.  CPU tensors take the plain ``blind_rotate64`` on the key
    given; CUDA tensors launch the kernel (each call adds one to
    ``blind_rotate_fused64_bg.launches``).
    """
    B = cts_ms.shape[0]
    if tb is None:
        tb = _bg_block(B)
        if tb is None:
            raise ValueError(
                f"batch-grid kernel needs B divisible into 8-aligned blocks "
                f"(got B={B}); use blind_rotate_fused64 instead")
    _check_bg_tb(B, tb)
    if cts_ms.device.type == "cpu":
        return blind_rotate64(params, bsk_rounded, luts, lut_idx, cts_ms)
    if cts_ms.device.type != "cuda":
        raise ValueError(f"no blind rotation kernel for {cts_ms.device}")
    _check64(params, bsk_rounded, luts, lut_idx, cts_ms)
    acc = _launch64("fhe_blind_rotate64_bg", params, bsk_rounded, luts,
                    lut_idx, cts_ms, tb)
    blind_rotate_fused64_bg.launches += 1
    return acc


blind_rotate_fused64_bg.launches = 0
