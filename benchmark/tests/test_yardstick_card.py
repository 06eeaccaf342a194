"""On the card, at each cell's own size: the control (the nearest
precision below the configuration's bf16, `benchmark/calibrate.py`) fails
one of the cell's limits on three seeds.  Skips without a card.

    python -m pytest -m cuda benchmark/tests/test_yardstick_card.py -q
"""

import pytest
import torch

from benchmark.calibrate import control_readings
from benchmark.cells import Bench

SEEDS = (2 ** 31 + 401, 2 ** 31 + 402, 2 ** 31 + 403)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      Bench().spec["workloads"]])
def test_the_control_is_not_correct(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bench = Bench()
    limits = bench.limits(workload)
    for seed in SEEDS:
        readings = control_readings(bench, workload, seed,
                                    torch.device("cuda", 0), 8.0)
        control = readings["control_int8"]
        assert any(control[k] > limits[k] for k in limits if k in control), \
            (seed, control, limits)
