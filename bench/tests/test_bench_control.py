"""The control, the reference computed in bfloat16 in the program's place,
has to come out not correct; the same reference in the configuration's
float32, or in float64, passes.  At a size a test run holds; the chip runs
the same at the cells' own sizes (``bench/control.py``)."""

import pytest
import torch

from bench import harness
from bench.systems import Control
from bench.tests.tiny import CELLS, tiny


def control(dtype):
    def make(cfg, tr, names):
        return Control(cfg, tr, dtype)
    return make


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [3, 2**31 + 5, 99])
def test_bfloat16_control_fails(name, seed):
    out = harness.run_cell(tiny(name), seed, 1.0, False, "cpu",
                           system=control(torch.bfloat16))
    assert out["correct"] is False
    gap = out["checks"]["score_gap"]
    assert gap["value"] > 10 * gap["limit"]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_stated_precision_passes(name, dtype):
    out = harness.run_cell(tiny(name), 41, 1.0, False, "cpu",
                           system=control(dtype))
    assert out["correct"] is True
