"""Host-side guarantees of the PyTorch port (fhe_regex_tpu_torch).

* The host modules it copies from the JAX package stay copies: the same
  code and docstrings, with only the package name changed and the
  reference checkout named relative to the repository where the JAX
  module gives an absolute path (comments may be reworded), so the two
  cannot drift.
* Importing and running the port, its serving daemon included, loads
  neither jax nor fhe_regex_tpu.
* chip_smoke.py has no CPU fallback: without a CUDA device, and alone in
  a directory, it exits non-zero at once and prints no result.
* The CLI and the kernel build helper behave on a machine without CUDA.
"""

import ast
import dataclasses
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "fhe_regex_tpu_torch"

COPIED = [
    "params.py",
    "crypto/__init__.py",
    "crypto/csprng.py",
    "crypto/glwe.py",
    "crypto/lwe.py",
    "crypto/keys.py",
    "crypto/golden.py",
    "crypto/native_fft.py",
    "crypto/refkey.py",
    "ops/luts.py",
    "regex/parser.py",
    "regex/circuit.py",
    "regex/engine.py",
    "regex/native.py",
    "utils/__init__.py",
    "utils/watchdog.py",
    "utils/security.py",
    "models/__init__.py",
    "models/patterns.py",
]


def _env():
    """A child environment that cannot see a CUDA device."""
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["PYTHONPATH"] = ""
    return env


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_equals_original(rel):
    original = (ROOT / "fhe_regex_tpu" / rel).read_text()
    copy = (PORT / rel).read_text()
    renamed = original.replace("fhe_regex_tpu.", "fhe_regex_tpu_torch.")
    renamed = renamed.replace("from fhe_regex_tpu import",
                              "from fhe_regex_tpu_torch import")
    renamed = re.sub(r"/\w+/reference/", "reference/", renamed)
    assert ast.dump(ast.parse(copy)) == ast.dump(ast.parse(renamed))
    assert copy.count("\n") == renamed.count("\n")


@pytest.mark.parametrize("path", sorted(p.relative_to(PORT).as_posix()
                                        for p in PORT.rglob("*.py")))
def test_port_source_imports_no_jax(path):
    src = (PORT / path).read_text()
    assert not re.search(r"^\s*(import|from)\s+jax\b", src, re.M)
    assert not re.search(r"^\s*(import|from)\s+fhe_regex_tpu(\.|\s|$)", src,
                         re.M)


def test_port_runs_without_jax(tmp_path):
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import torch\n"
        "torch.set_num_threads(2)\n"
        "from fhe_regex_tpu_torch import (decrypt, encrypt_str, gen_keys,\n"
        "    get_params, has_match)\n"
        "ck, sk = gen_keys(get_params('TEST_PARAMS'), seed=3)\n"
        "res = has_match(sk, encrypt_str(ck, 'xaby'), '/ab/', device='cpu')\n"
        "assert decrypt(ck, res) == 1\n"
        "ck, sk = gen_keys(get_params('TEST_PARAMS_64'), seed=3)\n"
        "res = has_match(sk, encrypt_str(ck, 'xaby'), '/ab/', device='cpu')\n"
        "assert res.dtype.name == 'uint64' and decrypt(ck, res) == 1\n"
        "import fhe_regex_tpu_torch.serve\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'fhe_regex_tpu'\n"
        "             or m.startswith('fhe_regex_tpu.'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_refuses_without_cuda(tmp_path, where):
    script = ROOT / "chip_smoke.py"
    if where == "alone":
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    res = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         env=_env(), capture_output=True, text=True,
                         timeout=60)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    assert "no CUDA device" in res.stderr


def test_cli_on_cpu(capsys):
    from fhe_regex_tpu_torch.cli import main

    args = ["--params", "TEST_PARAMS", "--trivial", "--device", "cpu",
            "--seed", "1"]
    assert main(args + ["abc", "/b/"]) == 0
    assert main(args + ["--fold", "tree", "abc", "/x/"]) == 0
    assert capsys.readouterr().out.splitlines() == ["res: 1", "res: 0"]
    assert main(args + ["abc", "/[0-9]/"]) == 2          # Q4: parse error
    assert main(args + ["--backend", "cuda-fused", "abc", "/b/"]) == 2


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    from fhe_regex_tpu_torch.ops import pbs_cuda

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(pbs_cuda, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        pbs_cuda.build()
    path = pbs_cuda.library_path()
    assert path.parent == tmp_path / "build"
    assert path == pbs_cuda.library_path()        # keyed by the sources only


def test_kernel_build_is_locked(monkeypatch, tmp_path):
    """Ranks that reach the build at once (torchrun on one host) compile
    the library once: the first holds the lock and builds, the others
    wait on it and load that build."""
    import threading
    import time

    from fhe_regex_tpu_torch.ops import pbs_cuda

    monkeypatch.setattr(pbs_cuda, "BUILD_DIR", tmp_path / "build")
    builds = []

    def fake_compile(out):
        builds.append(out)
        time.sleep(0.2)
        out.write_bytes(b"library")

    monkeypatch.setattr(pbs_cuda, "_compile", fake_compile)
    got = []
    ranks = [threading.Thread(target=lambda: got.append(pbs_cuda.build()))
             for _ in range(4)]
    for t in ranks:
        t.start()
    for t in ranks:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in ranks)
    assert builds == [pbs_cuda.library_path()]
    assert got == [pbs_cuda.library_path()] * 4


def test_kernel_wrapper_rejects_other_devices():
    from fhe_regex_tpu_torch.ops.pbs_cuda import blind_rotate_fused
    from fhe_regex_tpu_torch.params import get_params

    p = get_params("TEST_PARAMS")
    meta = torch.empty((2, p.lwe_dimension + 1), dtype=torch.int32,
                       device="meta")
    with pytest.raises(ValueError, match="no blind rotation kernel"):
        blind_rotate_fused(p, meta, meta, meta, meta)


def test_chip_profile_refuses_without_cuda():
    res = subprocess.run([sys.executable, str(ROOT / "chip_profile.py")],
                         cwd=ROOT, env=_env(), capture_output=True,
                         text=True, timeout=60)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr


def test_chip_profile_busy_time_is_a_union():
    """Overlapping device intervals count once, gaps not at all."""
    import types

    from chip_profile import busy_us

    def ev(s, e):
        return types.SimpleNamespace(
            time_range=types.SimpleNamespace(start=s, end=e))

    assert busy_us([ev(0, 10), ev(5, 12), ev(20, 30), ev(21, 22)]) == 22
    assert busy_us([]) == 0


@pytest.mark.parametrize("name", ["TPU_MESSAGE_2_CARRY_2",
                                  "REF_MESSAGE_2_CARRY_2_64",
                                  "TPU64_MESSAGE_2_CARRY_2", "TEST_PARAMS",
                                  "TEST_PARAMS_NOISY", "TEST_PARAMS_64"])
def test_security_and_cost_models_equal_jax(name, monkeypatch):
    """The copied lattice estimate and the communication model give the
    JAX package's numbers at every named parameter set: the port keeps the
    formulas and only its default figures are the card's, so both packages
    get the JAX package's figures here."""
    from fhe_regex_tpu.params import get_params as jget
    from fhe_regex_tpu.utils import metrics as jmetrics
    from fhe_regex_tpu.utils import security as jsecurity

    from fhe_regex_tpu_torch.params import get_params
    from fhe_regex_tpu_torch.utils import metrics, security

    def plain(d):
        """The estimate with its dataclasses as dicts (the two packages'
        classes never compare equal)."""
        return {k: dataclasses.asdict(v) if dataclasses.is_dataclass(v)
                else v for k, v in d.items()}

    mine, theirs = get_params(name), jget(name)
    assert (plain(security.estimate_params(mine))
            == plain(jsecurity.estimate_params(theirs)))
    rate, bw, lat, nbw, nlat = 950.0, 45e9, 5e-6, 25e9, 50e-6
    monkeypatch.setattr(metrics, "TP_GLUE_FRACTION",
                        jmetrics.TP_GLUE_FRACTION)
    for D, B, hosts in ((1, 256, 1), (4, 256, 1), (8, 1792, 2)):
        assert (metrics.comm_model(
                    mine, D, B, hosts=hosts, pbs_rate_per_chip=rate,
                    link_bw=bw, link_lat=lat, net_bw=nbw, net_lat=nlat)
                == jmetrics.comm_model(
                    theirs, D, B, hosts=hosts, pbs_rate_per_chip=rate,
                    ici_bw=bw, ici_lat=lat, dcn_bw=nbw, dcn_lat=nlat))


def test_metrics_defaults_are_h100_figures():
    """The port's communication-model defaults are the card's: NVLink 4 at
    450 GB/s each way, a 400 Gb/s NDR port per card, the 1829 PBS/s
    measured on an H100 at B = 256 and a TP split measured by
    chip_profile.py; no TPU figure or term is left in the module."""
    import inspect

    from fhe_regex_tpu_torch.utils import metrics

    kw = {k: v.default for k, v in
          inspect.signature(metrics.comm_model).parameters.items()
          if v.default is not inspect.Parameter.empty}
    assert kw == {"pbs_rate_per_chip": 1829.0, "link_bw": 450e9,
                  "link_lat": 1e-5, "net_bw": 50e9, "net_lat": 2e-5,
                  "hosts": 1}
    prof = metrics.TP_PROFILE
    assert prof["source"].startswith("chip_profile.py")
    assert "H100" in prof["measured"] and "700" in prof["measured"]
    assert prof["total_s"] > prof["ext_product_s"] > prof["glue_s"] > 0
    assert abs(prof["ext_product_s"] + prof["glue_s"] - prof["total_s"]) < 1e-9
    assert metrics.TP_GLUE_FRACTION == prof["glue_s"] / prof["total_s"]
    src = (PORT / "utils" / "metrics.py").read_text()
    assert not re.search(r"v5e|\bICI\b|\bDCN\b|\bMXU\b|ici_|dcn_|bf16|"
                         r"\bTPU\b|197\.0|950\.0", src)
