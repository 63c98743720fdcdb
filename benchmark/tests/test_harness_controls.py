"""The comparison that decides ``correct`` can fail: on the CPU, at sizes a
test holds, every cell passes with the program as it is, fails with the
reference's control in the program's place, and fails with the timed path
broken underneath in each way the cell can be broken."""

import pytest

from harness_small import control_checks, run_small, small_cell
from mcbench import faults

CELLS = ["std6_league_es9_es8", "equity_hu_queries", "std6_selfplay_random",
         "equity_sweep169"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result, err = run_small(cell)
    assert result["correct"], result
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert all(c["value"] == 0 for c in result["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    checks = control_checks(cell)
    assert not all(c.ok for c in checks), checks


FAULTS = {"std6_league_es9_es8": ["unchanged", "half", "altered",
                                   "reported"],
          "std6_selfplay_random": ["unchanged", "half", "altered",
                                   "reported"],
          "equity_hu_queries": ["unchanged", "half", "altered"],
          "equity_sweep169": ["unchanged", "half", "altered"]}


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS
                                        for f in FAULTS[c]])
def test_fault_fails(monkeypatch, cell, fault):
    _, _, _, traffic, _ = small_cell(cell)
    for module, name, fn in faults.plant(traffic["driver"], fault):
        monkeypatch.setattr(module, name, fn)
    result, _ = run_small(cell)
    assert not result["correct"], result
    if fault == "reported":
        assert result["checks"]["total_off"]["value"] == 1
