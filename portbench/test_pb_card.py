"""The controls of ``correct`` on the card, at each cell's own size and
load: the program served on a bootstrap key rounded below the precision
the configuration states (each of its "controls": one int8 limb more,
which decrypts wrong, and a finer rounding, which still decrypts right),
on three seeds, must come out not correct.  Prints each run's compared
numbers, the upper readings of PERF.md's limits.  Skips without a CUDA
device.

    python -m pytest portbench/test_pb_card.py -q -m card -s
"""

import time

import pytest

from portbench import harness, tfhe

SPEC = harness.load_json(harness.CHECKOUT / "BENCHMARK.json")
CELLS = [w["name"] for w in SPEC["workloads"]]
SEEDS = (3100000001, 3100000002, 3100000003)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_controls_are_not_correct_at_the_cells_size(cell, cuda):
    w = harness.workload(SPEC, cell)
    cfg = harness.load_json(harness.HERE / "configs" / f"{w['config']}.json")
    for control in cfg["controls"]:
        bits = control["round_bsk_bits"]
        for seed in SEEDS:
            res = harness.run_cell(
                SPEC, cell, seed, SPEC["run_seconds"], False, cuda,
                time.time(),
                key_transform=lambda p, bsk: tfhe.round_bsk(p, bsk, bits))
            print(f"control {cell} {control['name']} seed {seed} "
                  f"round_bsk_bits {bits}: " + ", ".join(
                      f"{k} {v['value']!r}" for k, v in
                      res["checks"].items()), flush=True)
            assert not res["correct"], res["checks"]
