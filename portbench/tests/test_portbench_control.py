"""The comparison separates: at a test's size the program's answers pass
the tiny configurations' limits and the control's (the reference in the
precision below the configuration's) fail them; on the card, at a cell's
own size, the control fails the cell's limits."""
from __future__ import annotations

import json

import pytest

from conftest import BENCH, TINY_LIMITS


def fails(numbers: dict, limits: dict) -> list:
    return [n for n, lim in limits.items() if n in numbers and numbers[n] > lim]


@pytest.mark.parametrize("cell,kind", [("tiny-flat.batch", "flat"), ("tiny-sq8r.batch", "sq8r")])
def test_control_fails_at_a_test_size(tiny_root, cell, kind):
    import control
    import run

    c = run.load_cell(cell, tiny_root / "portbench")
    for seed in (1, 2, 3):
        got = control.readings(c["config"], c["mix"], seed, "cpu")
        assert fails(got, TINY_LIMITS[kind]), (seed, got)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["sift1m-flat.batch", "deep10m-sq8r.batch"])
def test_control_fails_at_the_cells_size(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own size")
    import control
    import run

    c = run.load_cell(cell)
    cfg = json.loads((BENCH / "configs" / f"{c['config']['name']}.json").read_text())
    for seed in (21, 22, 23):
        got = control.readings(cfg, c["mix"], seed, "cuda")
        assert fails(got, cfg["limits"]), (seed, got)
