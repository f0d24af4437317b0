"""The check of ``correct`` against its control and the faults a cell can
have, at a test size on the CPU: the harness's run without its look for a
chip, with the timed path broken underneath, must come out not correct.
The card's own runs of the controls at the cells' sizes are in
``test_pb_card.py``."""

import numpy as np
import pytest

from portbench import harness, tfhe

DATA = harness.HERE / "testdata"
SPEC = {
    "workloads": [
        {"name": "tiny32.tiny_many", "config": "tiny32",
         "traffic": "tiny_many", "chips": 1},
        {"name": "tiny32.tiny_single", "config": "tiny32",
         "traffic": "tiny_single", "chips": 1}],
    "end_to_end": [], "per_layer": []}
CELLS = [w["name"] for w in SPEC["workloads"]]


def run(cell, seed=20260000001, key_transform=None):
    import time

    return harness.run_cell(SPEC, cell, seed, 1.5, False, "cpu",
                            time.time(), data_dir=DATA,
                            key_transform=key_transform)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = run(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0, res


@pytest.mark.parametrize("cell", CELLS)
def test_control_lower_precision_key_is_not_correct(cell):
    cfg = harness.load_json(DATA / "configs" / "tiny32.json")
    bits = cfg["controls"][0]["round_bsk_bits"]
    res = run(cell, key_transform=lambda p, bsk: tfhe.round_bsk(p, bsk,
                                                                bits))
    assert not res["correct"], res["checks"]
    assert res["checks"]["phase_gap"]["value"] > \
        res["checks"]["phase_gap"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_step_that_returns_its_state_is_not_correct(cell, monkeypatch):
    from fhe_regex_tpu_torch.ops import pbs

    monkeypatch.setattr(pbs, "external_product_step",
                        lambda params, digits, ggsw_i, acc: acc)
    res = run(cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_answer_altered_where_assembled_is_not_correct(cell, monkeypatch):
    from fhe_regex_tpu_torch.regex import executor

    orig = executor._assemble_root

    def altered(params, val, ct_u):
        out = orig(params, val, ct_u)
        with np.errstate(over="ignore"):
            out[0, -1] += out.dtype.type(params.delta)
        return out

    monkeypatch.setattr(executor, "_assemble_root", altered)
    res = run(cell)
    assert not res["correct"], res["checks"]
    assert res["checks"]["wrong_answers"]["value"] > 0


def test_half_of_the_batch_left_out_is_not_correct(monkeypatch):
    from fhe_regex_tpu_torch.regex.executor import Executor

    orig = Executor.run_many

    def half(self, circuit, contents, **kw):
        h = max(1, len(contents) // 2)
        out = orig(self, circuit, contents[:h], **kw)
        return np.stack([out[i % h] for i in range(len(contents))])

    monkeypatch.setattr(Executor, "run_many", half)
    res = run(CELLS[0])
    assert not res["correct"], res["checks"]
    assert res["checks"]["duplicate_replies"]["value"] > 0
