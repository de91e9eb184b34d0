"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card skipped, the rest of the run driven on the
CPU with VectorStore.search (the store under the Flight edge and the
coalescer) broken in one way a test."""
from __future__ import annotations

import numpy as np
import pytest

from conftest import run_tiny


def half_left_out(ids, scores, ok):
    ok = ok.copy()
    ok[ok.shape[0] // 2:] = False  # the second half of the batch goes unanswered
    return ids, scores, ok


def answer_altered(ids, scores, ok):
    ids = ids.copy()
    ids[:, 0] = np.array([(int(i) + 7) % 20_000 if i is not None else None for i in ids[:, 0]],
                         dtype=object)
    return ids, scores, ok


class Unchanged:
    """Returns the state it first produced, whatever it is asked."""

    def __init__(self):
        self.first = None

    def __call__(self, ids, scores, ok):
        if self.first is None or self.first[0].shape != ids.shape:
            self.first = (ids, scores, ok)
        return self.first


@pytest.mark.parametrize("fault", [half_left_out, answer_altered, Unchanged()],
                         ids=["half_left_out", "answer_altered", "state_unchanged"])
@pytest.mark.parametrize("cell", ["tiny-flat.batch", "tiny-sq8r.batch"])
def test_broken_path_is_not_correct(tiny_root, capsys, monkeypatch, fault, cell):
    from longbow_tpu_torch.store.vector_store import VectorStore

    orig = VectorStore.search

    def broken(self, dataset, queries, k, **kw):
        return fault(*orig(self, dataset, queries, k, **kw))

    monkeypatch.setattr(VectorStore, "search", broken)
    rc, res = run_tiny(tiny_root, cell, 77, 0, capsys)
    assert rc == 0 and res["correct"] is False, res["checks"]


def test_sound_path_is_correct(tiny_root, capsys):
    rc, res = run_tiny(tiny_root, "tiny-flat.batch", 77, 0, capsys)
    assert rc == 0 and res["correct"] is True, res["checks"]
