"""A run with the timed path broken underneath comes out not ``correct``:
once for each fault a cell can have (a step that returns its state
unchanged, half of the batch left out, an answer altered where it is
produced, a detector output altered; ``faults.py``), on the small CPU copies
of the cells, and on the card at the cells' own size. A sound run of each
copy comes out ``correct``. There is no exchange between cards to leave
out: every cell runs on one card."""
from __future__ import annotations

import json

import pytest
import torch

from benchmark.harness import checks as ck
from benchmark.harness import registry
from benchmark.tests import tiny
from benchmark.tests.faults import FAULTS


@pytest.fixture(scope="module")
def here(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell", ["d435_single.track", "d435_single.init", "lmo8_multi.track"])
def test_sound_run_is_correct(here, cell):
    out = tiny.run(here, cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_caught(here, monkeypatch, fault):
    cell, plant = FAULTS[fault]
    plant(monkeypatch)
    out = tiny.run(here, cell)
    assert not out["correct"], out["checks"]
    if fault.startswith("detector_altered"):
        assert out["checks"]["det_gap"]["value"] > out["checks"]["det_gap"]["limit"]
    if fault == "tracks_not_stepped":
        assert out["checks"]["missed_updates"]["value"] > 0


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 and the cells' own size exist only there")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["d435_single.track", "d435_single.init", "lmo8_multi.track"])
def test_tf32_control_fails_on_the_card(tmp_path, cell):
    """The control (the reference computed in TF32 in the program's place)
    comes out not ``correct``."""
    _need_card()
    here = tiny.make(tmp_path)
    out = tiny.run(here, cell, control="tf32", device="cuda")
    assert not out["correct"], out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_caught_at_the_cells_size(monkeypatch, fault):
    """Each fault planted under the cell itself (its own configuration,
    traffic and limits, a short window) comes out not ``correct``; the
    numbers compared are printed beside their limits."""
    _need_card()
    from benchmark.harness import cell as hcell

    cell, plant = FAULTS[fault]
    plant(monkeypatch)
    out = hcell.run(cell, 3000000019, 8.0, False, None, "cuda", here=registry.HERE)
    ck.detail(f"fault {fault} in {cell}: " + json.dumps(out["checks"]))
    assert not out["correct"], out["checks"]
