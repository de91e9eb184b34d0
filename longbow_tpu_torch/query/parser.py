"""Ticket parsing — reference-compatible JSON query format.

Counterpart of longbow_tpu/query/parser.py.

Wire format (reference: query/requests.go:4-21, zero_alloc_parser.go:
13-20,114-141,243-284):

    {"name"|"dataset": str, "limit": int,
     "search": {"dataset": str, "vector": [f32], "vectors": [[f32]],
                "k": int, "filters": [{"field","operator"|"op",
                "value","logic"}], "local_only": bool,
                "text_query": str, "alpha": f32, "graph_alpha": f32,
                "include_vectors": bool, "vector_format": str}}

CPython's float parsing is the hot cost of a large ticket.
parse_ticket therefore runs a guarded fast path on
tickets of 1 KiB and more: the "vector"/"vectors" numeric span is cut
out and parsed by the native library (lb_json_f32: strtof straight into
a float32 buffer, native_src/longbow_native.cpp), and stdlib json
parses only the small remainder. Any ambiguity - a second key
occurrence, a parse error, nesting deeper than 2, NaN or Inf, the span
not being the structural value - falls back to the full stdlib parse,
so the result is the stdlib's on every malformed or adversarial ticket.
A native library that cannot be built raises NativeBuildError; it is
not a fallback.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


# Operator aliases (reference: filter_evaluator.go:63-90)
_OP_ALIASES = {
    "=": "eq", "==": "eq", "eq": "eq",
    "!=": "neq", "neq": "neq", "ne": "neq",
    ">": "gt", "gt": "gt",
    "<": "lt", "lt": "lt",
    ">=": "ge", "ge": "ge", "gte": "ge",
    "<=": "le", "le": "le", "lte": "le",
    # extension beyond the reference's six ops: value is a JSON list;
    # served O(1) by the column inverted index (query/prefilter.py)
    "in": "in",
}


@dataclass
class Filter:
    field: str
    operator: str
    value: str
    logic: str = ""  # "and" (default) / "or"

    def __post_init__(self):
        op = _OP_ALIASES.get(self.operator.lower().strip())
        if op is None:
            raise ValueError(f"unknown filter operator {self.operator!r}")
        self.operator = op

    def cache_key(self) -> str:
        # reference: Filter.Hash (zero_alloc_parser.go:31)
        return f"{self.field}:{self.operator}:{self.value}:{self.logic}"


@dataclass
class VectorSearchRequest:
    dataset: str = ""
    vector: Optional[list] = None
    vectors: Optional[list] = None
    k: int = 10
    filters: list = field(default_factory=list)
    local_only: bool = False
    text_query: str = ""
    alpha: float = 0.0
    graph_alpha: float = 0.0
    # spreading-activation hop budget (reference: graph_depth search
    # param, docs/graph_rag.md:74-90)
    graph_depth: int = 2
    fusion: str = "linear"  # linear | rrf | cascade
    include_vectors: bool = False
    vector_format: str = ""
    # read consistency for fan-out searches (reference: QuorumManager
    # ONE/QUORUM/ALL reads, quorum.go:93-126); "" = best-effort
    consistency: str = ""

    def query_vectors(self) -> list:
        """Normalized batch of query vectors (a list of rows, or a 2D
        float32 ndarray — both np.asarray() identically at the call
        sites)."""
        if self.vectors is not None and len(self.vectors):
            return self.vectors
        if self.vector is not None:
            if isinstance(self.vector, np.ndarray):
                return self.vector.reshape(1, -1)
            return [self.vector]
        return []


@dataclass
class TicketQuery:
    name: str = ""
    limit: int = 0
    search: Optional[VectorSearchRequest] = None
    # filtered table scan (reference SDK download_arrow/download_stream
    # send {"name": ..., "filters": [...]} as a DoGet ticket,
    # longbowclientsdk client.py:259-291)
    filters: list = field(default_factory=list)


def _parse_filters(raw) -> list:
    out = []
    for f in raw or []:
        if not isinstance(f, dict):
            raise ValueError("filter must be an object")
        val = f.get("value", "")
        # scalar values stringify (the reference's parser reads them as
        # strings, zero_alloc_parser.go:243); `in` lists stay lists so
        # the inverted index can take them element-wise
        out.append(
            Filter(
                field=f.get("field", ""),
                operator=f.get("operator", f.get("op", "eq")),
                value=val if isinstance(val, list) else str(val),
                logic=f.get("logic", ""),
            )
        )
    return out


def parse_consistency(raw) -> str:
    """A read consistency level as a request sends it -> "", "ONE",
    "QUORUM" or "ALL" (case-insensitive); anything else is a ValueError."""
    level = str(raw or "").upper()
    if level not in ("", "ONE", "QUORUM", "ALL"):
        raise ValueError(f"consistency must be ONE|QUORUM|ALL, got {level!r}")
    return level


def parse_search_request(obj: dict) -> VectorSearchRequest:
    if not isinstance(obj, dict):
        raise ValueError("search request must be an object")
    req = VectorSearchRequest(
        dataset=obj.get("dataset", ""),
        vector=obj.get("vector"),
        vectors=obj.get("vectors"),
        # explicit None check: `or 10` silently turned an explicit
        # k=0 into 10, making the positivity guard unreachable
        k=(10 if obj.get("k") is None else int(obj["k"])),
        filters=_parse_filters(obj.get("filters")),
        local_only=bool(obj.get("local_only", False)),
        text_query=obj.get("text_query", "") or "",
        alpha=float(obj.get("alpha", 0.0) or 0.0),
        graph_alpha=float(obj.get("graph_alpha", 0.0) or 0.0),
        graph_depth=(
            2
            if obj.get("graph_depth") is None
            else int(obj["graph_depth"])
        ),
        fusion=str(obj.get("fusion", "linear") or "linear"),
        include_vectors=bool(obj.get("include_vectors", False)),
        vector_format=obj.get("vector_format", "") or "",
        consistency=parse_consistency(obj.get("consistency")),
    )
    if req.k <= 0:
        raise ValueError(f"k must be positive, got {req.k}")
    if req.vector_format not in ("", "f32", "f16", "quantized"):
        raise ValueError(
            f"vector_format must be f32|f16|quantized, "
            f"got {req.vector_format!r}"
        )
    return req


# `"vector":` / `"vectors":` key followed by an array open bracket
_VEC_KEY_RE = re.compile(rb'"(vectors?)"\s*:\s*\[')
# below this, stdlib json is as fast as the fast path's fixed overhead
_FAST_MIN_BYTES = 1024


def _fast_parse(data: bytes):
    """Native-assisted ticket parse: cut out the query-vector numeric
    span, parse it with lb_json_f32, stdlib-parse the small remainder,
    then check that the span really was the structural "vector"/"vectors"
    value. Returns (obj, key, arr), or None for the stdlib parse: no key,
    a SECOND key occurrence anywhere (a key inside a string would be
    ambiguous), nesting deeper than 2, NaN/Inf, a malformed remainder, or
    the key not landing where the cut put it."""
    from longbow_tpu_torch.storage.native import get_lib

    lib = get_lib()  # NativeBuildError when it cannot be built
    m = _VEC_KEY_RE.search(data)
    if m is None or _VEC_KEY_RE.search(data, m.end()) is not None:
        return None
    start = m.end() - 1  # at '['
    span = data[start:]
    cap = len(span) // 2 + 2  # every float costs >= 1 char + separator
    out = np.empty(cap, np.float32)
    rows = ctypes.c_int64(0)
    consumed = ctypes.c_uint64(0)
    n = lib.lb_json_f32(
        span, len(span),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        cap, ctypes.byref(rows), ctypes.byref(consumed),
    )
    if n < 0:
        return None
    # The cut span is replaced by a per-call random sentinel string, and
    # the parse is accepted only if the sentinel comes back as
    # search.<key>'s value. A fixed placeholder (such as null) could be
    # spoofed: {"params": {"vector": [..]}, "search": {"vector": null}}
    # would pass a `search[key] is None` check and install params' floats
    # as the query, numbers the stdlib parse ignores. A sentinel that
    # cannot be in the ticket beforehand proves the span's position.
    sentinel = "lbfp:" + os.urandom(8).hex()
    remainder = b'%s"%s"%s' % (
        data[:start], sentinel.encode(), data[start + consumed.value:]
    )
    try:
        obj = json.loads(remainder)
    except ValueError:  # JSONDecodeError, or bytes that are not UTF-8
        return None
    key = m.group(1).decode()
    search = obj.get("search") if isinstance(obj, dict) else None
    if not isinstance(search, dict) or search.get(key) != sentinel:
        return None
    arr = out[:n]
    if key == "vectors":
        nr = rows.value
        if nr <= 0 or n % nr:
            return None  # a ragged batch: the stdlib parse raises cleanly
        arr = arr.reshape(nr, n // nr)
    elif rows.value:
        return None  # a nested array under "vector" is not a fast shape
    return obj, key, arr


def parse_ticket(data: bytes | str) -> TicketQuery:
    """Parse a DoGet ticket (reference: ParseTicketQuerySafe,
    zero_alloc_parser.go:639). Byte tickets of _FAST_MIN_BYTES or more
    take _fast_parse; its query vectors come back as a float32 ndarray
    ([D] for "vector", [B, D] for "vectors") where the stdlib parse gives
    lists."""
    fast = None
    if isinstance(data, (bytes, bytearray)) and len(data) >= _FAST_MIN_BYTES:
        fast = _fast_parse(bytes(data))
    if fast is not None:
        obj, key, arr = fast
        obj["search"][key] = arr
    else:
        if isinstance(data, (bytes, bytearray)):
            data = bytes(data).decode("utf-8")
        try:
            obj = json.loads(data)
        except json.JSONDecodeError as e:
            raise ValueError(f"malformed ticket JSON: {e}") from e
    if not isinstance(obj, dict):
        raise ValueError("ticket must be a JSON object")
    tq = TicketQuery(
        # "dataset" is an alias for "name" (zero_alloc_parser.go:121)
        name=obj.get("name") or obj.get("dataset") or "",
        limit=int(obj.get("limit", 0) or 0),
        filters=_parse_filters(obj.get("filters")),
    )
    if "search" in obj and obj["search"] is not None:
        tq.search = parse_search_request(obj["search"])
        if not tq.search.dataset:
            tq.search.dataset = tq.name
        if not tq.name:
            tq.name = tq.search.dataset
    return tq
