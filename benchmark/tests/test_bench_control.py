"""The control (the plain reference with every mismatch budget one lower,
``control.py``) fails the comparison that decides ``correct``, on three
seeds of each cell at the tests' size; the reference against itself
passes it."""
import pytest

import control
import judge
from small import SPEC, small_cell

SEEDS = (11, 2 ** 31 + 7, 977)


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
@pytest.mark.parametrize("seed", SEEDS)
def test_control_is_not_correct(workload, seed):
    row = control.control(small_cell(workload), seed, "cpu")
    assert row["reference_lines"] > 0
    assert row["report_lines_differing"] > judge.LIMIT, row
    assert row["report_files_differing"] > judge.LIMIT, row
