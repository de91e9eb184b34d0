"""Ticket parsing — reference-compatible JSON query format.

Counterpart of longbow_tpu/query/parser.py on the stdlib-json path only
(the native fast parse of the query-vector span is not ported yet).

Wire format (reference: query/requests.go:4-21, zero_alloc_parser.go:
13-20,114-141,243-284):

    {"name"|"dataset": str, "limit": int,
     "search": {"dataset": str, "vector": [f32], "vectors": [[f32]],
                "k": int, "filters": [{"field","operator"|"op",
                "value","logic"}], "local_only": bool,
                "text_query": str, "alpha": f32, "graph_alpha": f32,
                "include_vectors": bool, "vector_format": str}}
"""
from __future__ import annotations

import json
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
        consistency=str(obj.get("consistency", "") or "").upper(),
    )
    if req.k <= 0:
        raise ValueError(f"k must be positive, got {req.k}")
    if req.consistency not in ("", "ONE", "QUORUM", "ALL"):
        raise ValueError(
            f"consistency must be ONE|QUORUM|ALL, got {req.consistency!r}"
        )
    if req.vector_format not in ("", "f32", "f16", "quantized"):
        raise ValueError(
            f"vector_format must be f32|f16|quantized, "
            f"got {req.vector_format!r}"
        )
    return req


def parse_ticket(data: bytes | str) -> TicketQuery:
    """Parse a DoGet ticket (reference: ParseTicketQuerySafe,
    zero_alloc_parser.go:639)."""
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
