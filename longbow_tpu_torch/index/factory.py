"""Index construction behind one uniform surface.

Counterpart of longbow_tpu/index/factory.py. Only the "flat" kind is
ported; every other kind the reference knows raises NotImplementedError
naming it, so a caller learns what is missing instead of getting a
different index.
"""
from __future__ import annotations

import numpy as np

from longbow_tpu_torch.index.flat import MIN_CAPACITY, FlatIndex

INDEX_KINDS = (
    "adaptive", "flat", "hnsw", "pq", "sq8", "sq8r", "bq", "disk",
    "ivf",
    "mesh_flat", "mesh_graph",
)


def _not_ported(kind: str) -> NotImplementedError:
    return NotImplementedError(
        f"index kind {kind!r} is not yet ported to longbow_tpu_torch "
        "(only 'flat' is)"
    )


class _FlatAdapter:
    """The surface the Dataset uses — search(q, k, *, filter_mask,
    ef_search, exact) — over a FlatIndex. ef_search does not apply to an
    exhaustive scan; exact=True goes to exact_search."""

    kind = "flat"
    accepts_blocks = True

    def __init__(self, inner: FlatIndex):
        self._flat = inner
        self.dim = inner.dim
        self.metric = inner.metric

    @property
    def capacity(self) -> int:
        return self._flat.capacity

    def __len__(self) -> int:
        return len(self._flat)

    def add(self, vecs) -> np.ndarray:
        return self._flat.add(vecs)

    def delete_rows(self, rows) -> None:
        self._flat.delete_rows(rows)

    def flush(self) -> None:
        self._flat.flush()

    def search(self, queries, k, *, filter_mask=None, ef_search=None,
               exact=False):
        return self._flat.search(queries, k, filter_mask=filter_mask, exact=exact)

    def warm(self) -> None:
        self._flat.warm()

    def get_vectors(self, rows) -> np.ndarray:
        return self._flat.get_vectors(rows)

    def export_state(self) -> dict:
        return self._flat.export_state()


def make_index(kind: str, dim: int, metric: str, *, dtype, device=None, **params):
    """A new index of `kind`. params: capacity (rows to preallocate)."""
    kind = (kind or "adaptive").lower()
    if kind == "flat":
        capacity = int(params.get("capacity", 0))
        return _FlatAdapter(
            FlatIndex(dim, metric, dtype, capacity=max(capacity, 0) or MIN_CAPACITY,
                      device=device)
        )
    if kind in INDEX_KINDS:
        raise _not_ported(kind)
    raise ValueError(f"unknown index kind {kind!r}; want one of {INDEX_KINDS}")


def import_index(state: dict, *, device=None):
    """Rebuild an index from export_state() output (this package's or
    longbow_tpu's)."""
    kind = state["kind"]
    if kind == "flat":
        return _FlatAdapter(FlatIndex.import_state(state, device=device))
    if kind in INDEX_KINDS:
        raise _not_ported(kind)
    raise ValueError(f"cannot import index state of kind {kind!r}")
