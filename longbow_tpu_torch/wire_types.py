"""Canonical wire/WAL vector dtype matrix.

The SINGLE source of truth for which vector dtypes are preserved
end-to-end — SDK upload, DoPut admission, WAL frames, dataset staging
(reference ingests these natively with a published per-dtype
throughput matrix, docs/performance.md:27-53). Kept numpy-only so the
storage tier can import it without pulling the jax-heavy store tier.

float64 is deliberately excluded: every index kind stages to f32/bf16,
so preserving f64 would double wire + WAL bytes for zero retained
precision (np.asarray over plain Python lists defaults to f64 — the
most common SDK input shape). int32 rides the wire and WAL natively
but converts to f32 at the dataset boundary (values > 2^24 round, as
in the reference).
"""
from __future__ import annotations

import numpy as np

NATIVE_VECTOR_DTYPES = frozenset(
    np.dtype(t)
    for t in (np.float32, np.float16, np.int8, np.uint8, np.int32)
)

# schema metadata key naming a dataset's metric (reference:
# dataset.go:176-189); on put streams, search exchanges and schemas
METRIC_METADATA_KEY = "longbow.metric"
