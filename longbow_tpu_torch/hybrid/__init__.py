"""Hybrid dense+sparse search, rank fusion, and GraphRAG.

Counterpart of longbow_tpu/hybrid/.

Sparse/BM25 stays host-side — term-frequency lookups are pointer-heavy
and tiny compared to the dense path, so CPU is the right home for them
(SURVEY.md §7 step 4); fusion and graph re-ranking operate on the
top-k lists, also host-side.
"""
from longbow_tpu_torch.hybrid.bm25 import BM25Index  # noqa: F401
from longbow_tpu_torch.hybrid.fusion import fuse_linear, fuse_rrf  # noqa: F401
from longbow_tpu_torch.hybrid.graph_store import GraphStore  # noqa: F401
