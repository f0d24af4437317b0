#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json`` "workloads")
names a configuration and a traffic mix; the run makes keys and traffic
from the seed, starts the port's serving daemon in this process, warms
the cell's shapes, drives it with one closed-loop client for the given
seconds and checks every reply against the plain reference.  The last
line of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``; with ``--trace 1`` also
``breakdown``; the compared numbers last, under ``checks``), and the last
lines of standard error are the compared numbers beside their limits.

Needs a CUDA device (exit 2 without one, no result); exits 3, with no
result, if JAX or the JAX package was loaded.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
CACHE = CHECKOUT / ".cache" / "portbench"


def _environment() -> None:
    """Run the program as its configuration states, with its caches at
    fixed places inside the checkout."""
    for name in list(os.environ):
        if name.startswith("FHE_REGEX_"):
            del os.environ[name]
    for name, sub in (("CUDA_CACHE_PATH", "nv"),
                      ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                      ("TRITON_CACHE_DIR", "triton")):
        os.environ[name] = str(CACHE / sub)
    if str(CHECKOUT) not in sys.path:
        sys.path.insert(0, str(CHECKOUT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    from portbench import harness

    spec = harness.load_json(CHECKOUT / "BENCHMARK.json")
    chips = harness.workload(spec, args.workload)["chips"]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(spec, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"portbench: the run loaded {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
