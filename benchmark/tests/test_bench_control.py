"""The control: the reference with float8 products (the precision below
the configuration's bf16) put in the program's place, at the cell's own
size on the card, must come out not correct; and the program's own first
steps there must come out correct. Card only."""

import pytest

from benchmark import check
from benchmark.calibrate import readings
from benchmark.run import load_cell

from .conftest import CELLS


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(card, name):
    limits = load_cell(name)[2]["limits"]
    row = readings(name, [2**31 + 101], control=1, fault_names=[], fault_seeds=0)[0]
    assert check.judge(row["sound"], limits), row["sound"]
    assert not check.judge(row["control"], limits), row["control"]
