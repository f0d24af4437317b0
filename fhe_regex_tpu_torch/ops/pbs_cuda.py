"""The hand-written CUDA blind rotations (``csrc/*.cu``).

The Hopper counterparts of ``fhe_regex_tpu/ops/pbs_pallas.py``'s kernels:
the whole n-step CMUX ladder for a batch, with the LUT selection and the
initial X^{-b~} rotation built on the device, or one CMUX stage at a time.

  ``blind_rotate_fused``      32-bit, ``csrc/blind_rotate.cu``
                              (``_fused_blindrot_kernel``): through the
                              spectral key (``spectral::ext_product``,
                              float64 FFTs) where the key has one (the
                              sets of ``spectral_supported``), else the
                              int8 limb GEMM (``stage1`` and
                              ``ext_product`` each step)
  ``blind_rotate_fused_bg``   32-bit over batch blocks, same source
                              (``_fused_blindrot_bg_kernel``); with the
                              spectral key, the spectral rotation of the
                              whole batch
  ``stage1_digits``           one CMUX step's digits, same source
                              (``_stage1_kernel``)
  ``stage1_digits64``         one CMUX step's 64-bit digit limbs, the pass
                              ``stage1_64`` that #5 and #6 run each step,
                              ``csrc/blind_rotate64.cu``
  ``external_product_step``   one CMUX step's external product, same
                              source (``_ext_product_kernel``)
  ``external_product_rows``   the same over a block of the digit rows, one
                              rank's share of a step under tensor
                              parallelism (``parallel/tensor.py``)
  ``blind_rotate_steps``      the rotation as a Python loop over the two
                              above (``blind_rotate_pallas``)
  ``blind_rotate_fused64``    64-bit, ``csrc/blind_rotate64.cu``
                              (``_fused_blindrot64_stacked_kernel`` /
                              ``_fused_blindrot64_kernel``)
  ``blind_rotate_fused64_bg`` 64-bit over batch blocks, same source
                              (``_fused_blindrot64_bg_kernel``)

``rotation_steps()`` counts the CMUX steps x rows of the 32-bit fused
rotations by the path they took, ``spectral`` or ``limb`` (and, of the
spectral ones, ``spectral_pair``: those on the cluster pair that
``spectral_cluster`` chooses for narrow batches), and
``rotation_launches()`` their launches by the kernel each launched.

Every wrapper takes its plain PyTorch version (``ops/pbs.py``,
``ops/pbs64.py``) on CPU tensors and launches its kernel on CUDA tensors,
adding one to its ``launches`` count per launch; it never falls back.  A
CUDA graph's replay counts through ``add_launches``.

The library is compiled with ``nvcc`` for ``sm_90a`` at first use, into
``build/`` at the repository root, keyed by a hash of the sources and the
header they share (one ``nvcc`` per source, all at once, then one link),
and bound through ``ctypes`` (plain C entry points, no PyTorch headers).
The build holds an exclusive ``fcntl`` lock on a file beside it, so the
ranks of one host (``torchrun --nproc-per-node``) build it once between
them.  Nothing is compiled or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from fhe_regex_tpu_torch.ops import pbs as plain
from fhe_regex_tpu_torch.ops import pbs64
from fhe_regex_tpu_torch.ops.pbs import blind_rotate
from fhe_regex_tpu_torch.ops.pbs64 import blind_rotate64, n_digit_limbs
from fhe_regex_tpu_torch.params import Params

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
SOURCES = ("blind_rotate.cu", "blind_rotate64.cu")
HEADERS = ("hopper.cuh",)
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
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libfheregex_cuda-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a build of the current sources exists:
    every source at once into an object file, then one shared library.
    Processes that build at once wait on one lock; the first builds and
    the others find its library."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{out.stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)     # released when the file closes
        if not out.exists():
            _compile(out)
    return out


def _compile(out: Path) -> None:
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


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        signatures = {   # (pointers, ints), then the stream
            "fhe_blind_rotate": (6, 6),
            "fhe_blind_rotate_bg": (6, 7),
            "fhe_blind_rotate_spectral": (6, 7),
            "fhe_stage1_digits": (3, 5),
            "fhe_external_product_rows": (4, 4),
            "fhe_blind_rotate64": (6, 10),
            "fhe_stage1_digits64": (3, 6),
        }
        for name, (ptrs, ints) in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = [ptr] * ptrs + [i32] * ints + [ptr]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _call(entry: str, device: torch.device, *args) -> None:
    """Enqueue one C entry point on the current stream of ``device``; a
    nonzero cudaError_t raises."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(_load(), entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry} failed: cudaError_t {err}")


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


def _check_aligned(name: str, t: torch.Tensor, why: str) -> None:
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary ({why})")


def _on_cuda(what: str, t: torch.Tensor) -> bool:
    """False for a CPU tensor (take the plain version), True for a CUDA
    one (launch); any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no {what} kernel for {t.device}")
    return True


def _check_params32(params: Params) -> None:
    N, l = params.polynomial_size, params.pbs_level
    if params.torus_bits != 32:
        raise ValueError("the CUDA blind rotation is 32-bit only")
    if N % 256 or N & (N - 1):
        raise ValueError(f"N={N}: the kernel needs a power of two >= 256")
    if params.pbs_base_log > 7 or params.pbs_base_log * l >= 32:
        raise ValueError("the kernel's int8 digits need base_log <= 7 and "
                         "base_log * level < 32")


def _check32(params: Params, bsk, luts, lut_idx, cts_ms) -> None:
    _check_params32(params)
    k1 = params.glwe_dimension + 1
    N, n, l = params.polynomial_size, params.lwe_dimension, params.pbs_level
    B = cts_ms.shape[0]
    if B < 1:
        raise ValueError("empty batch")
    dev = cts_ms.device
    _check("cts_ms", cts_ms, (B, n + 1), torch.int32, dev)
    _check("luts", luts, (luts.shape[0], N), torch.int32, dev)
    _check("lut_idx", lut_idx, (B,), torch.int32, dev)
    _check("bsk", bsk, (n, k1 * l, k1, N), torch.int32, dev)


def _launch(entry: str, params: Params, bsk, luts, lut_idx, cts_ms,
            tb: "int | None", drop: tuple = (0, 0)) -> torch.Tensor:
    """One whole-rotation entry point.  32 bits: int32 accumulators and
    int8 digits, over batch blocks when ``tb`` is given.  64 bits: int64
    accumulators and ``n_digit_limbs`` int8 planes per digit row, over
    batch blocks of ``tb`` (None: one block), with the key-limb ``drop``."""
    k1 = params.glwe_dimension + 1
    N, n, l = params.polynomial_size, params.lwe_dimension, params.pbs_level
    B, dev = cts_ms.shape[0], cts_ms.device
    wide = params.torus_bits == 64
    acc = torch.empty((B, k1, N), device=dev,
                      dtype=torch.int64 if wide else torch.int32)
    nd, tail = 1, ()
    if wide:
        tb, nd = tb or B, n_digit_limbs(params.pbs_base_log)
        tail = (nd, *drop)
    digits = torch.empty((tb or B, k1 * l * nd, N), device=dev,
                         dtype=torch.int8)
    blocks = () if tb is None else (tb,)
    _call(entry, dev, cts_ms.data_ptr(), luts.data_ptr(), lut_idx.data_ptr(),
          bsk.data_ptr(), acc.data_ptr(), digits.data_ptr(), B, *blocks, n,
          k1, N, l, params.pbs_base_log, *tail)
    return acc


_ROTATION_STEPS = {"spectral": 0, "spectral_pair": 0, "limb": 0}
_ROTATION_LAUNCHES = {"fhe_blind_rotate_spectral": 0, "spectral_pair": 0,
                      "fhe_blind_rotate": 0, "fhe_blind_rotate_bg": 0}


def rotation_steps() -> dict:
    """{"spectral": n, "spectral_pair": n, "limb": n}: CMUX steps x rows of
    the 32-bit fused rotations (``blind_rotate_fused``,
    ``blind_rotate_fused_bg``) on the card, by the path each took;
    ``spectral_pair`` is the part of ``spectral`` that ran on the cluster
    pair (what a CUDA graph replays is not counted; neither backend is
    captured by default)."""
    return dict(_ROTATION_STEPS)


def rotation_launches() -> dict:
    """{entry point: launches} of the same rotations, by the kernel each
    launched: the spectral one (of which ``spectral_pair`` counts the
    launches on the cluster pair), or the limb GEMM of
    ``blind_rotate_fused`` or of ``blind_rotate_fused_bg``.  Kept apart
    from ``launch_counts``, whose wrappers count either."""
    return dict(_ROTATION_LAUNCHES)


def spectral_cluster(B: int, sms: int) -> int:
    """Blocks an instance of the spectral rotation of B rows on a card of
    ``sms`` SMs: 2, the cluster pair (``spectral::pair``, a GLWE component
    a block, on two SMs), while the pairs fit one wave (2 B <= sms: B <= 66
    on an H100 SXM), else 1 (``spectral::ext_product<T>``, which itself
    takes T = 2 instances a block above one wave)."""
    return 2 if 2 * B <= sms else 1


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    """The SM count of a CUDA ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def spectral_supported(params: Params) -> bool:
    """Whether the spectral rotation takes this parameter set: 32 bits,
    N = 2048, k = 1, l = 3 (its transforms and slots are sized for them)."""
    return (params.torus_bits == 32 and params.polynomial_size == 2048
            and params.glwe_dimension == 1 and params.pbs_level == 3)


@functools.lru_cache(maxsize=None)
def _spectral_tables(N: int, device: torch.device) -> torch.Tensor:
    """The twist and twiddle tables on ``device``, made once (a copy to
    the device inside a CUDA graph capture would break it)."""
    from fhe_regex_tpu_torch.ops.pbs_fft import spectral_tables

    return spectral_tables(N, device)


def _rotate_spectral(params: Params, spec: torch.Tensor, luts, lut_idx,
                     cts_ms, cluster: "int | None" = None) -> torch.Tensor:
    """One launch of the spectral rotation on the key spectrum ``spec``
    [n, (k+1)l, k+1, 2, N/2] complex128 (``pbs_fft.prepare_bsk_fft`` on
    ``pbs_fft.SPECTRAL_PLAN``), on ``cluster`` blocks an instance (None:
    ``spectral_cluster``'s choice for the device)."""
    from fhe_regex_tpu_torch.ops.pbs_fft import C128, SPECTRAL_PLAN

    if not spectral_supported(params):
        raise ValueError(f"{params.name}: the spectral rotation takes N = "
                         f"2048, k = 1, l = 3 only")
    k1, N, n = (params.glwe_dimension + 1, params.polynomial_size,
                params.lwe_dimension)
    B, dev = cts_ms.shape[0], cts_ms.device
    _check("spec", spec,
           (n, k1 * params.pbs_level, k1, len(SPECTRAL_PLAN), N // 2), C128,
           dev)
    if cluster is None:
        cluster = spectral_cluster(B, _sm_count(dev))
    acc = torch.empty((B, k1, N), device=dev, dtype=torch.int32)
    _call("fhe_blind_rotate_spectral", dev, cts_ms.data_ptr(),
          luts.data_ptr(), lut_idx.data_ptr(), spec.data_ptr(),
          _spectral_tables(N, dev).data_ptr(), acc.data_ptr(), B, n, k1, N,
          params.pbs_level, params.pbs_base_log, cluster)
    return acc


def _rotate32(entry: str, params: Params, bsk, luts, lut_idx, cts_ms,
              tb, spec) -> torch.Tensor:
    """The spectral rotation where ``spec`` is given (on the cluster pair
    where ``spectral_cluster`` chooses it), else the limb GEMM's ``entry``;
    counts the launch and the steps by path.  No width goes to the limb
    GEMM when a spectrum is given: the spectral rotation is the faster at
    every batch from 8 to 1024 rows (``chip_smoke.py`` phase 18 sweeps
    both)."""
    B = cts_ms.shape[0]
    steps = params.lwe_dimension * B
    if spec is not None:
        cluster = spectral_cluster(B, _sm_count(cts_ms.device))
        acc = _rotate_spectral(params, spec, luts, lut_idx, cts_ms, cluster)
        entry, path = "fhe_blind_rotate_spectral", "spectral"
        if cluster == 2:
            _ROTATION_LAUNCHES["spectral_pair"] += 1
            _ROTATION_STEPS["spectral_pair"] += steps
    else:
        acc = _launch(entry, params, bsk, luts, lut_idx, cts_ms, tb)
        path = "limb"
    _ROTATION_LAUNCHES[entry] += 1
    _ROTATION_STEPS[path] += steps
    return acc


def blind_rotate_fused(params: Params, bsk: torch.Tensor, luts: torch.Tensor,
                       lut_idx: torch.Tensor, cts_ms: torch.Tensor,
                       spec: "torch.Tensor | None" = None) -> torch.Tensor:
    """[B, n+1] mod-switched cts -> [B, k+1, N] int32 accumulators.

    Same contract as ``ops.pbs.blind_rotate``: bsk [n, (k+1)l, k+1, N] int32,
    luts [L, N] int32, lut_idx [B] int32 with values in [0, L).  CPU tensors
    take that plain version; CUDA tensors launch the kernel (each call adds
    one to ``blind_rotate_fused.launches``): the spectral rotation on
    ``spec``, the key's spectrum (``DeviceServerKey.spec``), where it is
    given, else the limb GEMM on ``bsk``.
    """
    if not _on_cuda("blind rotation", cts_ms):
        return blind_rotate(params, bsk, luts, lut_idx, cts_ms)
    _check32(params, bsk, luts, lut_idx, cts_ms)
    acc = _rotate32("fhe_blind_rotate", params, bsk, luts, lut_idx, cts_ms,
                    None, spec)
    blind_rotate_fused.launches += 1
    return acc


blind_rotate_fused.launches = 0


BG_CAP = 896      # the JAX package's 32-bit batch-block cap
BG64_CAP = 512    # and its 64-bit one


def _bg_block(B: int, cap: int) -> "int | None":
    """Largest tb <= cap with B % tb == 0 and tb % 8 == 0; None if none
    (the JAX package's ``_bg_block``; caps ``BG_CAP`` / ``BG64_CAP``)."""
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


def _resolve_tb(B: int, tb: "int | None", cap: int, fallback: str) -> int:
    if tb is None:
        tb = _bg_block(B, cap)
        if tb is None:
            raise ValueError(
                f"batch-grid kernel needs B divisible into 8-aligned blocks "
                f"(got B={B}); use {fallback} instead")
    _check_bg_tb(B, tb)
    return tb


def blind_rotate_fused_bg(params: Params, bsk: torch.Tensor,
                          luts: torch.Tensor, lut_idx: torch.Tensor,
                          cts_ms: torch.Tensor, tb: "int | None" = None,
                          spec: "torch.Tensor | None" = None) -> torch.Tensor:
    """``blind_rotate_fused`` over batch blocks of ``tb`` instances, one
    block's whole rotation after another (the JAX ``pallas-bg`` backend,
    block-major as it runs at 32 bits).

    ``tb=None`` takes the largest 8-aligned divisor of B up to 896; a B
    with none, or an explicit ``tb`` that does not cover B exactly, raises
    ValueError.  CPU tensors take the plain ``blind_rotate``; CUDA tensors
    launch the kernel (each call adds one to
    ``blind_rotate_fused_bg.launches``).  With ``spec`` it runs the spectral
    rotation as ``blind_rotate_fused`` does, over the whole batch of any
    B: that kernel keeps no working set in L2 that batch blocks would
    bound, so it takes no ``tb`` (an explicit one raises ValueError).
    """
    if spec is not None:
        if tb is not None:
            raise ValueError(f"batch block tb={tb}: the spectral rotation "
                             f"takes the whole batch")
    else:
        tb = _resolve_tb(cts_ms.shape[0], tb, BG_CAP, "blind_rotate_fused")
    if not _on_cuda("blind rotation", cts_ms):
        return blind_rotate(params, bsk, luts, lut_idx, cts_ms)
    _check32(params, bsk, luts, lut_idx, cts_ms)
    acc = _rotate32("fhe_blind_rotate_bg", params, bsk, luts, lut_idx,
                    cts_ms, tb, spec)
    blind_rotate_fused_bg.launches += 1
    return acc


blind_rotate_fused_bg.launches = 0


def stage1_digits(params: Params, acc: torch.Tensor,
                  a: torch.Tensor) -> torch.Tensor:
    """One CMUX step's digits, the contract of ``ops.pbs.stage1_digits``:
    acc [B, k+1, N] int32, a [B] int32 in [0, 2N) -> [B, (k+1)l, N] int8.
    CPU tensors take that plain version; CUDA tensors launch the kernel
    (each call adds one to ``stage1_digits.launches``), which reads acc in
    16-byte groups: an acc not 16-byte aligned raises ValueError."""
    if not _on_cuda("stage1", acc):
        return plain.stage1_digits(params, acc, a)
    _check_params32(params)
    k1, N = params.glwe_dimension + 1, params.polynomial_size
    l, B, dev = params.pbs_level, acc.shape[0], acc.device
    _check("acc", acc, (B, k1, N), torch.int32, dev)
    _check("a", a, (B,), torch.int32, dev)
    _check_aligned("acc", acc, "the kernel stages it with 16-byte loads")
    digits = torch.empty((B, k1 * l, N), dtype=torch.int8, device=dev)
    _call("fhe_stage1_digits", dev, a.data_ptr(), acc.data_ptr(),
          digits.data_ptr(), B, k1, N, l, params.pbs_base_log)
    stage1_digits.launches += 1
    return digits


stage1_digits.launches = 0


def _external_product(params: Params, digits, ggsw, acc,
                      rows: int) -> torch.Tensor:
    """One ``fhe_external_product_rows`` launch over ``rows`` digit rows:
    digits [B, rows, N] int8, ggsw [rows, k+1, N], acc [B, k+1, N] -> a new
    [B, k+1, N]."""
    _check_params32(params)
    k1, N = params.glwe_dimension + 1, params.polynomial_size
    B, dev = acc.shape[0], acc.device
    _check("acc", acc, (B, k1, N), torch.int32, dev)
    _check("digits", digits, (B, rows, N), torch.int8, dev)
    _check("ggsw", ggsw, (rows, k1, N), torch.int32, dev)
    _check_aligned("digits", digits,
                   "the kernel stages them with 16-byte cp.async")
    out = torch.empty_like(acc)
    _call("fhe_external_product_rows", dev, digits.data_ptr(),
          ggsw.data_ptr(), acc.data_ptr(), out.data_ptr(), B, k1, N, rows)
    return out


def external_product_step(params: Params, digits: torch.Tensor,
                          ggsw_i: torch.Tensor,
                          acc: torch.Tensor) -> torch.Tensor:
    """acc + sum_r digits[:, r] (*) ggsw_i[r, c], the contract of
    ``ops.pbs.external_product_step``: digits [B, (k+1)l, N] int8, ggsw_i
    [(k+1)l, k+1, N] int32, acc [B, k+1, N] int32 -> a new [B, k+1, N]
    int32 (acc is not changed).  CPU tensors take that plain version; CUDA
    tensors launch the kernel (each call adds one to
    ``external_product_step.launches``)."""
    if not _on_cuda("external product", acc):
        return plain.external_product_step(params, digits, ggsw_i, acc)
    rows = (params.glwe_dimension + 1) * params.pbs_level
    out = _external_product(params, digits, ggsw_i, acc, rows)
    external_product_step.launches += 1
    return out


external_product_step.launches = 0


def external_product_rows(params: Params, digits: torch.Tensor,
                          ggsw_rows: torch.Tensor,
                          acc: torch.Tensor) -> torch.Tensor:
    """``external_product_step`` over R of the (k+1)l digit rows: acc +
    sum_r digits[:, r] (*) ggsw_rows[r, c] for digits [B, R, N] int8 (a
    contiguous block of a step's digit rows), ggsw_rows [R, k+1, N] int32
    (the same rows of the step's GGSW), acc [B, k+1, N] int32 -> a new
    [B, k+1, N] int32.  Under tensor parallelism each rank runs it on its
    row block and a zero acc, and the partial sums meet in an all-reduce.
    CPU tensors take the plain ``ops.pbs.external_product_step``, which
    takes any row count; CUDA tensors launch #1's device code over R rows
    (each call adds one to ``external_product_rows.launches``)."""
    if not _on_cuda("external product", acc):
        return plain.external_product_step(params, digits, ggsw_rows, acc)
    R = digits.shape[1]
    if not 1 <= R <= (params.glwe_dimension + 1) * params.pbs_level:
        raise ValueError(f"{R} digit rows: a step has 1 to "
                         f"{(params.glwe_dimension + 1) * params.pbs_level}")
    out = _external_product(params, digits, ggsw_rows, acc, R)
    external_product_rows.launches += 1
    return out


external_product_rows.launches = 0


def blind_rotate_steps(params: Params, bsk: torch.Tensor, luts: torch.Tensor,
                       lut_idx: torch.Tensor,
                       cts_ms: torch.Tensor) -> torch.Tensor:
    """The blind rotation one CMUX stage per launch (the JAX ``pallas``
    backend, ``blind_rotate_pallas``): acc0 in torch, then a host loop
    over the n steps of ``stage1_digits`` and ``external_product_step``,
    2n launches.  Same contract as ``ops.pbs.blind_rotate``."""
    acc = plain.init_accumulator(params, luts, lut_idx, cts_ms)
    a_steps = cts_ms[:, :params.lwe_dimension].T.contiguous()     # [n, B]
    for i in range(params.lwe_dimension):
        digits = stage1_digits(params, acc, a_steps[i])
        acc = external_product_step(params, digits, bsk[i], acc)
    return acc


# ---------------- 64-bit torus ----------------


def _check_params64(params: Params) -> None:
    """The 64-bit sets the kernels take: N a power of two in [256, 4096]
    (the key windows of a block in shared memory; int32 limb-class sums
    exact for nd * N < 2^17), digits of 1 to 3 balanced int8 limbs (the
    ``ext_product64`` templates)."""
    N, l, bl = params.polynomial_size, params.pbs_level, params.pbs_base_log
    if params.torus_bits != 64:
        raise ValueError("the 64-bit blind rotation needs a 64-bit set")
    if N & (N - 1) or not 256 <= N <= 4096:
        raise ValueError(f"N={N}: the kernel needs a power of two in "
                         f"[256, 4096]")
    if bl * l > 31:
        raise ValueError("the kernel's rounding needs base_log * level "
                         "<= 31")
    nd = n_digit_limbs(bl)
    if nd > 3 or (1 << (bl - 1)) - 1 > 0x7F7F7F >> (8 * (3 - nd)):
        raise ValueError(f"base_log={bl}: the kernel splits a digit into "
                         f"1 to 3 balanced int8 limbs that must hold it")


def _check64(params: Params, bsk, luts, lut_idx, cts_ms,
             drop=(0, 0)) -> None:
    """What the 64-bit rotations take: a set ``_check_params64`` admits,
    a drop of 0 to 7 key limbs, and the tensors of ``blind_rotate64``."""
    _check_params64(params)
    k1 = params.glwe_dimension + 1
    N, n, l = params.polynomial_size, params.lwe_dimension, params.pbs_level
    if len(drop) != 2 or not all(0 <= m < 8 for m in drop):
        raise ValueError(f"key-limb drop {drop}: need two counts in [0, 8)")
    B = cts_ms.shape[0]
    if B < 1:
        raise ValueError("empty batch")
    dev = cts_ms.device
    _check("cts_ms", cts_ms, (B, n + 1), torch.int32, dev)
    _check("luts", luts, (luts.shape[0], N), torch.int64, dev)
    _check("lut_idx", lut_idx, (B,), torch.int32, dev)
    _check("bsk", bsk, (n, k1 * l, k1, N), torch.int64, dev)


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
    if not _on_cuda("blind rotation", cts_ms):
        return blind_rotate64(params, bsk, luts, lut_idx, cts_ms)
    _check64(params, bsk, luts, lut_idx, cts_ms)
    acc = _launch("fhe_blind_rotate64", params, bsk, luts, lut_idx,
                  cts_ms, None)
    blind_rotate_fused64.launches += 1
    return acc


blind_rotate_fused64.launches = 0


def blind_rotate_fused64_bg(params: Params, bsk_rounded: torch.Tensor,
                            luts: torch.Tensor, lut_idx: torch.Tensor,
                            cts_ms: torch.Tensor, tb: "int | None" = None,
                            drop: tuple = (0, 0)) -> torch.Tensor:
    """``blind_rotate_fused64`` over batch blocks of ``tb`` instances, each
    block running its whole rotation, on a key rounded by
    ``pbs64.round_bsk64`` (the JAX ``pallas64-bg`` backend).

    ``drop`` is the (mask, body) limb drop the key was rounded by
    (``DeviceServerKey.drop64``): the kernel skips the key limbs below it,
    which are zero only on a key so rounded.  ``tb=None`` takes the largest
    8-aligned divisor of B up to 512; a B with none, or an explicit ``tb``
    that does not cover B exactly, raises ValueError.  CPU tensors take the
    plain ``blind_rotate64`` on the key given (exact on the rounded key,
    so it needs no drop); CUDA tensors launch the kernel (each call adds
    one to ``blind_rotate_fused64_bg.launches``).
    """
    tb = _resolve_tb(cts_ms.shape[0], tb, BG64_CAP, "blind_rotate_fused64")
    if not _on_cuda("blind rotation", cts_ms):
        return blind_rotate64(params, bsk_rounded, luts, lut_idx, cts_ms)
    drop = tuple(int(m) for m in drop)
    _check64(params, bsk_rounded, luts, lut_idx, cts_ms, drop)
    acc = _launch("fhe_blind_rotate64", params, bsk_rounded, luts, lut_idx,
                  cts_ms, tb, drop)
    blind_rotate_fused64_bg.launches += 1
    return acc


blind_rotate_fused64_bg.launches = 0


def stage1_digits64(params: Params, acc: torch.Tensor,
                    a: torch.Tensor) -> torch.Tensor:
    """One CMUX step's 64-bit digit limbs, the contract of
    ``ops.pbs64.stage1_digits64``: acc [B, k+1, N] int64, a [B] int32 in
    [0, 2N) -> [B, (k+1)l * nd, N] int8, nd = ``n_digit_limbs``.  CPU
    tensors take that plain version; CUDA tensors launch ``stage1_64``
    alone (each call adds one to ``stage1_digits64.launches``), which reads
    acc in 16-byte groups: an acc not 16-byte aligned raises ValueError.
    The rotations of #5 and #6 launch the same device code each step."""
    if not _on_cuda("stage1_64", acc):
        return pbs64.stage1_digits64(params, acc, a)
    _check_params64(params)
    k1, N = params.glwe_dimension + 1, params.polynomial_size
    l, B, dev = params.pbs_level, acc.shape[0], acc.device
    nd = n_digit_limbs(params.pbs_base_log)
    _check("acc", acc, (B, k1, N), torch.int64, dev)
    _check("a", a, (B,), torch.int32, dev)
    _check_aligned("acc", acc, "the kernel stages it with 16-byte loads")
    digits = torch.empty((B, k1 * l * nd, N), dtype=torch.int8, device=dev)
    _call("fhe_stage1_digits64", dev, a.data_ptr(), acc.data_ptr(),
          digits.data_ptr(), B, k1, N, l, params.pbs_base_log, nd)
    stage1_digits64.launches += 1
    return digits


stage1_digits64.launches = 0


KERNELS = (blind_rotate_fused, blind_rotate_fused_bg, stage1_digits,
           external_product_step, external_product_rows,
           blind_rotate_fused64, blind_rotate_fused64_bg, stage1_digits64)


def launch_counts() -> dict:
    """{wrapper name: launches} of every kernel wrapper of this module."""
    return {k.__name__: k.launches for k in KERNELS}


def launch_delta(before: dict, after: dict) -> dict:
    """{wrapper name: launches} made between two ``launch_counts()``, the
    wrappers that made none left out."""
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def add_launches(delta: dict, times: int = 1) -> None:
    """Add ``times`` x ``delta`` ({wrapper name: launches}) to the counts.

    A CUDA graph replays the kernels its capture recorded without calling
    a wrapper, and a capture calls the wrappers without launching: the
    executor takes a capture's delta back once (``times=-1``) and adds it
    on every replay."""
    by_name = {k.__name__: k for k in KERNELS}
    for name, n in delta.items():
        by_name[name].launches += times * n
