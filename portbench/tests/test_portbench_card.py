"""On the card only: the control (the plain reference in TF32, one step
below the configurations' float32) fails each cell's check at the cell's
own size, on three seeds.

    python -m pytest portbench/tests -m card
"""

import pytest

from portbench import calibrate, registry

SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in
                                  registry.load_benchmark()["workloads"]])
@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails_the_check(card, name, seed):
    cell = registry.cell(name)
    got = calibrate.reading(cell, "control", seed, 0.0, card)
    assert any(got.get(k, 0.0) > lim for k, lim in cell.limits.items()), got
