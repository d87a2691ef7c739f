"""On the card only: each fault planted in DBDA (``faults_zoo.py``) fails
``serve-dbda-paviau``'s check at the cell's own size, as the TF32 control
does (``test_portbench_card.py``, every cell).

    python -m pytest portbench/tests -m card
"""

import pytest

from portbench import calibrate, faults_zoo, registry

SEED = 2 ** 31 + 120
#: seconds of window: the serving check compares the window's maps
WINDOW_S = 1.0


@pytest.mark.card
@pytest.mark.parametrize("fault", faults_zoo.FAULTS)
def test_a_dbda_fault_fails_the_check(card, fault):
    cell = registry.cell("serve-dbda-paviau")
    with faults_zoo.planted(fault):
        got = calibrate.reading(cell, "sound", SEED, WINDOW_S, card)
    assert any(got.get(k, 0.0) > lim for k, lim in cell.limits.items()), got
