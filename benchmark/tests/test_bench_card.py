"""On the card, at each cell's own size: a sound run of the port is correct,
and the control and each fault the cell can have are not. Several minutes;
run with ``python -m pytest benchmark/tests -m card``."""

import pytest

from benchmark.calibrate import readings

pytestmark = pytest.mark.card

CASES = [("serve-d64-batch32k", ["control", "fault:serve_altered", "fault:serve_half"]),
         ("serve-d256-batch32k", ["control", "fault:serve_altered"]),
         ("train-d256-fullgraph", ["control", "fault:train_half", "fault:train_unchanged"]),
         ("train-d64-fullnode", ["control", "fault:train_half", "fault:train_unchanged"])]


@pytest.mark.parametrize("cell,broken", CASES, ids=[c for c, _ in CASES])
def test_control_and_faults_fail_at_cell_size(card, cell, broken):
    seconds = 3.0 if cell.startswith("serve") else 0.1
    cache = {"keep_program": True}
    sound = readings(cell, [901], "program", seconds, cache=cache)
    assert all(ok for _, _, ok, _, _ in sound), sound
    for mode in broken:
        got = readings(cell, [902, 903, 904], mode, seconds, cache=cache)
        assert not any(ok for _, _, ok, _, _ in got), (mode, got)
