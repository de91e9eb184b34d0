"""Predicate filtering: metadata columns -> device row mask.

Counterpart of longbow_tpu/query/filters.py. Filterable columns live on
the index's device as tensors padded to the index capacity; a predicate
list evaluates to one torch.bool mask [capacity] that the search folds
into the validity mask (reference: query/filter_evaluator.go:18-540,
dataset.go:226-297 GenerateFilterBitset + LRU cache).

Integer columns are int64 tensors on the device (exact for ids past
2^31); float columns are float32; string columns are dictionary-encoded
(host dict value -> code, device int32 codes, -1 where absent).
"""
from __future__ import annotations

import json
import threading
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from longbow_tpu_torch.device import resolve_device
from longbow_tpu_torch.query.parser import Filter
from longbow_tpu_torch.query.prefilter import ColumnPrefilter


class ColumnStore:
    """Filterable metadata columns for one dataset."""

    def __init__(self, capacity: int, *, device=None):
        self.device = resolve_device(device)
        self.capacity = capacity
        self.count = 0
        self._numeric: dict[str, torch.Tensor] = {}    # int64 / float32
        self._str_codes: dict[str, torch.Tensor] = {}  # int32, -1 absent
        self._str_dicts: dict[str, dict] = {}          # value -> code
        # O(1) equality pre-filters: bloom + inverted row index per
        # string/int column (reference: column_inverted_index.go:47)
        self._prefilters: dict[str, ColumnPrefilter] = {}

    def _grow(self, new_cap: int) -> None:
        if new_cap <= self.capacity:
            return
        pad = new_cap - self.capacity

        def grown(col, fill):
            tail = torch.full((pad,), fill, dtype=col.dtype, device=self.device)
            return torch.cat([col, tail])

        self._numeric = {k: grown(v, 0) for k, v in self._numeric.items()}
        self._str_codes = {k: grown(v, -1) for k, v in self._str_codes.items()}
        self.capacity = new_cap

    def append(self, columns: dict, n: int, capacity: int, rows=None) -> None:
        """Append n rows of column data ({name: list/ndarray}).

        Columns absent from this batch keep the default fill (0, or code
        -1 for strings) so rows stay aligned across batches with
        different schemas (additive schema evolution). rows: explicit
        row positions, else the next n rows."""
        self._grow(capacity)
        start = self.count
        pos = (
            np.arange(start, start + n, dtype=np.int64)
            if rows is None
            else np.asarray(rows, np.int64)
        )
        pos_t = torch.as_tensor(pos, device=self.device)
        for name, vals in columns.items():
            arr = np.asarray(vals)
            if len(arr) != n:
                raise ValueError(
                    f"column {name!r} has {len(arr)} rows, expected {n}"
                )
            if arr.dtype.kind in "OUS":  # strings
                d = self._str_dicts.setdefault(name, {})
                keys = np.array([str(v) for v in arr], dtype=object)
                codes = np.array([d.setdefault(k, len(d)) for k in keys], np.int32)
                self._prefilters.setdefault(name, ColumnPrefilter()).add_batch(keys, pos)
                col = self._str_codes.get(name)
                if col is None:
                    col = torch.full((self.capacity,), -1, dtype=torch.int32, device=self.device)
                col[pos_t] = torch.as_tensor(codes, device=self.device)
                self._str_codes[name] = col
                continue
            is_int = arr.dtype.kind in "iu"
            vals_np = arr.astype(np.int64 if is_int else np.float32)
            col = self._numeric.get(name)
            if is_int and (col is None or col.dtype == torch.int64):
                # integer columns get the eq/in pre-filter (floats don't:
                # equality on floats is scan-path territory)
                self._prefilters.setdefault(name, ColumnPrefilter()).add_batch(
                    vals_np.astype("U"), pos
                )
            elif is_int:
                # an int batch onto a float column upcasts losslessly; the
                # column is now mixed, so the int pre-filter no longer
                # covers every row (float batches onto int columns are
                # rejected by check_types)
                vals_np = vals_np.astype(np.float32)
                self._prefilters.pop(name, None)
            if col is None:
                col = torch.zeros(
                    (self.capacity,),
                    dtype=torch.int64 if is_int else torch.float32,
                    device=self.device,
                )
            col[pos_t] = torch.as_tensor(vals_np, device=self.device)
            self._numeric[name] = col
        if rows is None:
            self.count = start + n
        elif len(pos):
            self.count = max(start, int(pos.max()) + 1)

    def check_types(self, columns: dict) -> None:
        """Reject type flips BEFORE any mutation so a bad write never
        half-applies (vectors landed, columns rejected)."""
        for name, vals in (columns or {}).items():
            kind = np.asarray(vals).dtype.kind
            is_str = kind in "OUS"
            if is_str and name in self._numeric:
                raise ValueError(
                    f"schema mismatch: column {name!r} is numeric, "
                    "got string values"
                )
            if not is_str and name in self._str_codes:
                raise ValueError(
                    f"schema mismatch: column {name!r} is string, "
                    "got numeric values"
                )
            col = self._numeric.get(name)
            if kind == "f" and col is not None and col.dtype == torch.int64:
                raise ValueError(
                    f"schema mismatch: column {name!r} is integer, "
                    "got float values (lossy cast rejected)"
                )

    def fields(self) -> list[str]:
        return sorted(set(self._numeric) | set(self._str_codes))

    def host_view(self, rows=None) -> dict:
        """name -> host array of every column, for streaming scans; with
        `rows`, gathered to those rows (on the device, so that a small
        limited scan fetches len(rows) values, not the column). String
        columns decode through a code-indexed array of their values; an
        absent value reads as ""."""
        rows_t = None
        if rows is not None:
            rows_t = torch.as_tensor(np.asarray(rows, np.int64), device=self.device)

        def fetch(col: torch.Tensor) -> np.ndarray:
            return (col if rows_t is None else col[rows_t]).cpu().numpy()

        out: dict[str, np.ndarray] = {k: fetch(v) for k, v in self._numeric.items()}
        for k, codes in self._str_codes.items():
            vocab = self._str_dicts[k]
            inv = np.empty(max(vocab.values(), default=-1) + 2, dtype=object)
            inv[:] = ""
            for val, c in vocab.items():
                inv[c] = val
            out[k] = inv[fetch(codes)]  # code -1 reads inv[-1], the ""
        return out

    # -- snapshot state ------------------------------------------------

    def export_state(self) -> dict:
        """The columns' first `count` rows as numpy, in longbow_tpu's layout:
        an int column whose values all fit int32 (|v| < 2^31) as int32,
        else int64 (the reference keeps such a column on the host), float
        columns as float32, string codes as int32 with their dictionaries.
        Every array is a copy: a write after the capture cannot reach it."""
        c = self.count
        num = {}
        for k, v in self._numeric.items():
            arr = np.array(v[:c].cpu().numpy())
            if arr.dtype == np.int64 and (np.abs(arr) < 2**31).all():
                arr = arr.astype(np.int32)
            num[k] = arr
        return {
            "count": c,
            "numeric": num,
            "str_codes": {k: np.array(v[:c].cpu().numpy()) for k, v in self._str_codes.items()},
            "str_dicts": {k: dict(v) for k, v in self._str_dicts.items()},
        }

    @classmethod
    def import_state(cls, st: dict, capacity: int, *, device=None) -> "ColumnStore":
        """From export_state() output, this package's or longbow_tpu's:
        int32 and int64 columns both become int64 tensors."""
        cs = cls(max(capacity, st["count"], 1), device=device)
        cs.count = st["count"]
        for k, arr in st["numeric"].items():
            arr = np.asarray(arr)
            arr = arr.astype(np.int64 if arr.dtype.kind in "iu" else np.float32)
            col = torch.zeros((cs.capacity,), dtype=torch.from_numpy(arr).dtype, device=cs.device)
            col[: len(arr)] = torch.from_numpy(arr).to(cs.device)
            cs._numeric[k] = col
        for k, arr in st["str_codes"].items():
            arr = np.asarray(arr, np.int32)
            col = torch.full((cs.capacity,), -1, dtype=torch.int32, device=cs.device)
            col[: len(arr)] = torch.from_numpy(arr).to(cs.device)
            cs._str_codes[k] = col
        for k, d in st["str_dicts"].items():
            cs._str_dicts[k] = {str(v): int(c) for v, c in d.items()}
        cs._rebuild_prefilters(st)
        return cs

    def _rebuild_prefilters(self, st: dict) -> None:
        """The eq/in pre-filters are derived state: rebuilt from the
        imported columns, as the reference rebuilds them."""
        n = st["count"]
        rows = np.arange(n, dtype=np.int64)
        for k, arr in st["numeric"].items():
            arr = np.asarray(arr)[:n]
            if arr.dtype.kind in "iu":
                self._prefilters.setdefault(k, ColumnPrefilter()).add_batch(
                    arr.astype(np.int64).astype("U"), rows
                )
        for k, codes in st["str_codes"].items():
            d = self._str_dicts.get(k, {})
            if not d:
                continue
            inv = np.empty(max(d.values()) + 1, dtype=object)
            for v, c in d.items():
                inv[c] = v
            codes = np.asarray(codes, np.int64)[:n]
            ok = codes >= 0
            self._prefilters.setdefault(k, ColumnPrefilter()).add_batch(inv[codes[ok]], rows[ok])

    # ------------------------------------------------------------------

    def _prefilter_mask(self, f: Filter) -> Optional[torch.Tensor]:
        """eq/in via the host inverted index: O(values) dict lookups +
        one bool-mask upload. None = not answerable here -> scan path."""
        if f.operator not in ("eq", "in"):
            return None
        pf = self._prefilters.get(f.field)
        if pf is None:
            return None
        vals = f.value if isinstance(f.value, (list, tuple)) else [f.value]
        is_str = f.field in self._str_dicts
        mask = np.zeros((self.capacity,), bool)
        for v in vals:
            if is_str:
                key = str(v)
                if key == "":
                    return None  # default fill is unindexed: scan
            else:
                try:
                    key = str(int(v))
                except (TypeError, ValueError):
                    return None  # the scan path raises the canonical error
                if key == "0":
                    # rows default-filled by absent-column appends hold 0
                    # but were never indexed — the scan path decides
                    return None
            r = pf.rows_for(key)
            if r is None:
                return None  # cardinality-capped column: bloom only
            if len(r):
                mask[r[r < self.capacity]] = True
        return torch.as_tensor(mask, device=self.device)

    def _eval_one(self, f: Filter) -> torch.Tensor:
        op = f.operator
        pm = self._prefilter_mask(f)
        if pm is not None:
            return pm
        in_vals = (
            list(f.value)
            if op == "in" and isinstance(f.value, (list, tuple))
            else [f.value] if op == "in" else None
        )
        if f.field in self._str_codes:
            if op not in ("eq", "neq", "in"):
                raise ValueError(
                    f"operator {op!r} unsupported for string column "
                    f"{f.field!r} (eq/neq/in only)"
                )
            d = self._str_dicts[f.field]
            col = self._str_codes[f.field]
            if op == "in":
                codes = [d.get(str(v), -2) for v in in_vals]
                return torch.isin(col, torch.tensor(codes, dtype=torch.int32, device=self.device))
            m = col == d.get(str(f.value), -2)  # -2: no match
            return m if op == "eq" else (col >= 0) & ~m
        if f.field in self._numeric:
            col = self._numeric[f.field]
            is_int = col.dtype == torch.int64
            if op == "in":
                vv = [int(v) if is_int else float(v) for v in in_vals]
                return torch.isin(col, torch.tensor(vv, dtype=col.dtype, device=self.device))
            try:
                val = int(f.value) if is_int else float(f.value)
            except ValueError as e:
                raise ValueError(
                    f"filter value {f.value!r} not numeric for column "
                    f"{f.field!r}"
                ) from e
            return {
                "eq": torch.eq, "neq": torch.ne, "gt": torch.gt,
                "lt": torch.lt, "ge": torch.ge, "le": torch.le,
            }[op](col, val)
        raise KeyError(f"unknown filter field {f.field!r}")

    def evaluate(self, filters: list[Filter]) -> Optional[torch.Tensor]:
        """Filters -> [capacity] bool mask; AND by default, a filter with
        logic == "or" ORs into the running mask."""
        if not filters:
            return None
        mask = None
        for f in filters:
            m = self._eval_one(f)
            if mask is None:
                mask = m
            elif f.logic.lower() == "or":
                mask = mask | m
            else:
                mask = mask & m
        return mask


class FilterCache:
    """LRU cache of evaluated filter masks keyed by the filters AND the
    store version: a mask computed from a pre-invalidation column
    snapshot cannot be stored after invalidate() ran."""

    def __init__(self, max_entries: int = 100):
        self.max_entries = max_entries
        self._d: OrderedDict[tuple, torch.Tensor] = OrderedDict()
        self._counts: OrderedDict[tuple, int] = OrderedDict()
        self._version = 0  # bumped on every append/delete
        self._lock = threading.Lock()

    def invalidate(self) -> None:
        with self._lock:
            self._version += 1
            self._d.clear()
            self._counts.clear()

    @staticmethod
    def _key(version: int, filters: list[Filter]) -> tuple:
        # structured key: joining raw strings with unescaped separators
        # let distinct filter lists collide
        return (
            version,
            json.dumps([[f.field, f.operator, f.value, f.logic] for f in filters]),
        )

    def get_or_eval_versioned(
        self, store: ColumnStore, filters: list[Filter]
    ) -> tuple[Optional[torch.Tensor], int]:
        """-> (mask, the store version it was evaluated under)."""
        if not filters:
            return None, self._version
        with self._lock:
            ver = self._version
            key = self._key(ver, filters)
            hit = self._d.get(key)
            if hit is not None:
                self._d.move_to_end(key)
                return hit, ver
        mask = store.evaluate(filters)
        with self._lock:
            if self._version == ver:  # don't store a stale snapshot
                self._d[key] = mask
                if len(self._d) > self.max_entries:
                    self._d.popitem(last=False)
        return mask, ver

    def selectivity_count(
        self, filters: list[Filter], mask: torch.Tensor, version: int
    ) -> int:
        """Eligible-row count of `mask`, which was evaluated under store
        `version` (get_or_eval_versioned's second value). Computed once
        per filter list and version - the reduction is a host read - and
        cached under THAT version: a write that lands between the mask's
        evaluation and this call bumps the version, and the count of the
        now stale mask is returned to its one caller and not kept."""
        key = self._key(version, filters)
        with self._lock:
            hit = self._counts.get(key)
            if hit is not None:
                return hit
        cnt = int(mask.sum())
        with self._lock:
            if self._version == version:
                self._counts[key] = cnt
                if len(self._counts) > self.max_entries:
                    self._counts.popitem(last=False)
        return cnt
