"""Host-side guarantees of the PyTorch port (fhe_regex_tpu_torch).

* The host modules it copies from the JAX package stay copies: the same
  code and docstrings, with only the package name changed (comments may be
  reworded), so the two cannot drift.
* Importing and running the port loads neither jax nor fhe_regex_tpu.
* chip_smoke.py has no CPU fallback: without a CUDA device, and alone in
  a directory, it exits non-zero at once and prints no result.
* The CLI and the kernel build helper behave on a machine without CUDA.
"""

import ast
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
    "ops/luts.py",
    "regex/parser.py",
    "regex/circuit.py",
    "regex/engine.py",
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


def test_kernel_wrapper_rejects_other_devices():
    from fhe_regex_tpu_torch.ops.pbs_cuda import blind_rotate_fused
    from fhe_regex_tpu_torch.params import get_params

    p = get_params("TEST_PARAMS")
    meta = torch.empty((2, p.lwe_dimension + 1), dtype=torch.int32,
                       device="meta")
    with pytest.raises(ValueError, match="no blind rotation kernel"):
        blind_rotate_fused(p, meta, meta, meta, meta)
