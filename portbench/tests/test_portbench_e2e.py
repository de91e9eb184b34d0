"""Tiny runs on the CPU through the port's Flight server, the load
generator's callers in processes of their own: each configuration, with
and without the trace."""
from __future__ import annotations

import pytest

from conftest import run_tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell,trace", [
    ("tiny-flat.batch", 0), ("tiny-flat.batch", 1), ("tiny-sq8r.batch", 1),
    ("tiny-sq8r.batch", 0),
])
def test_tiny_run(tiny_root, capsys, cell, trace):
    rc, res = run_tiny(tiny_root, cell, 3_000_000_017, trace, capsys)
    assert rc == 0 and res is not None
    assert list(res)[:5] == KEYS and list(res)[-1] == "checks"
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    names = set(res["metrics"])
    setup = {"setup.before_runtime_s", "setup.data_s", "setup.warm_flight_s"}
    if trace:
        assert "breakdown" in res and res["device"]["window_s"] > 0
        own = {"tiny-flat.batch": set(),
               "tiny-sq8r.batch": {"edge.added_ms.sq8r", "store.search_ms.sq8r"}}[cell]
        assert names == setup | own  # the device metrics: not on the CPU
    else:
        own = {"tiny-flat.batch": set(), "tiny-sq8r.batch": {"search_qps.sq8r"}}[cell]
        assert names == own | {"recall_at_10", "setup_s"}
        assert all(v["value"] > 0 for v in res["metrics"].values())
        assert len(res["host"]["client_cpu_s"]) == 2 and res["host"]["turnaround_ms"]["max"] >= 0


def test_cli_refuses_without_a_card(capsys):
    import run
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal needs a machine without one")
    rc = run.main(["--workload", "sift1m-flat.batch", "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out.strip() == ""
