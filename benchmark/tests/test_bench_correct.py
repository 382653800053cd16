"""``correct`` at a small size on the CPU: sound runs of the port pass, and
the control (the reference in the next lower precision in the program's
place) and each fault a cell can have, planted under the timed path, come
out not correct. The harness's look for a card is skipped; the rest of a run
is driven as on the card."""

import pytest

from benchmark.faults import FAULTS
from benchmark.tests.conftest import run_tiny


@pytest.mark.parametrize("cell", ["tiny-serve", "tiny-serve-dot", "tiny-train",
                                  "tiny-fullnode"])
@pytest.mark.parametrize("seed", [11, 2 ** 33 + 5])
def test_sound_run_is_correct(tiny, cell, seed):
    res = run_tiny(tiny, cell, seed=seed)
    assert res.correct, res.checks
    assert res.failed == 0 and res.attempted > 0


@pytest.mark.parametrize("cell", ["tiny-serve", "tiny-serve-dot", "tiny-train",
                                  "tiny-fullnode"])
def test_control_is_not_correct(tiny, cell):
    res = run_tiny(tiny, cell, seed=21, mode="control")
    assert not res.correct, res.checks


@pytest.mark.parametrize("cell,fault", [
    ("tiny-serve", "serve_altered"), ("tiny-serve", "serve_half"),
    ("tiny-serve-dot", "serve_altered"), ("tiny-serve-dot", "serve_half"),
    ("tiny-train", "train_unchanged"), ("tiny-train", "train_half"),
    ("tiny-fullnode", "train_unchanged"), ("tiny-fullnode", "train_half")])
def test_fault_is_not_correct(tiny, cell, fault):
    with FAULTS[fault]():
        res = run_tiny(tiny, cell, seed=31)
    assert not res.correct, (res.checks, res.failed)


@pytest.mark.parametrize("cell", ["tiny-train", "tiny-fullnode"])
def test_same_seed_same_inputs(tiny, cell):
    a = run_tiny(tiny, cell, seed=41)
    b = run_tiny(tiny, cell, seed=41)
    assert a.info["numbers"] == b.info["numbers"]
