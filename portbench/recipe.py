"""The corpus and query recipe, made from a seed.

A frozen torch copy of bench.py's make_corpus recipe: a mixture of 1,024
Gaussian clusters, centres drawn N(0, 1) and scaled by 4, rows and
queries a uniformly drawn centre plus unit noise. Rows are drawn on the
device in fixed blocks, each from its own generator, so that any range
of rows is made again alike by the reference; queries are drawn with
numpy on the host, one block of QUERY_BLOCK a generator, because the
load generator's process must not touch the card.

Imports numpy, and torch inside the functions that make rows: the
load generator's process imports this module without torch.
"""
from __future__ import annotations

import hashlib

import numpy as np

N_CENTRES = 1024
CENTRE_SCALE = 4.0
ROW_BLOCK = 65_536
QUERY_BLOCK = 1_000

# query streams: the window's queries, warm-up queries and the control's
STREAM_WINDOW, STREAM_WARM = 1, 2


def sub_seed(seed: int, *path) -> int:
    """A 63-bit seed of (seed, *path): any whole seed, however large."""
    h = hashlib.sha256(":".join(str(x) for x in (seed, *path)).encode()).digest()
    return int.from_bytes(h[:8], "little") & (2**63 - 1)


def centres(seed: int, dim: int) -> np.ndarray:
    """[N_CENTRES, dim] float32, on the host (both processes make them)."""
    rng = np.random.default_rng(sub_seed(seed, "centres"))
    return (rng.standard_normal((N_CENTRES, dim), dtype=np.float32) * CENTRE_SCALE)


def _row_block(seed: int, j: int, dim: int, cent) -> tuple:
    import torch

    g = torch.Generator(device=cent.device)
    g.manual_seed(sub_seed(seed, "rows", j))
    assign = torch.randint(0, N_CENTRES, (ROW_BLOCK,), generator=g, device=cent.device)
    noise = torch.randn((ROW_BLOCK, dim), generator=g, device=cent.device)
    return cent[assign] + noise, assign


def rows(seed: int, dim: int, start: int, end: int, cent, with_assign: bool = False):
    """Rows [start, end) of the corpus as float32 on cent's device
    (cent: centres() as a tensor there). with_assign: also each row's
    centre."""
    out, lab = [], []
    for j in range(start // ROW_BLOCK, (end - 1) // ROW_BLOCK + 1):
        blk, a = _row_block(seed, j, dim, cent)
        lo = max(start - j * ROW_BLOCK, 0)
        hi = min(end - j * ROW_BLOCK, ROW_BLOCK)
        out.append(blk[lo:hi])
        lab.append(a[lo:hi])
    import torch

    r = torch.cat(out) if len(out) > 1 else out[0]
    if with_assign:
        return r, (torch.cat(lab) if len(lab) > 1 else lab[0])
    return r


def query_block(seed: int, stream: int, j: int, cent: np.ndarray) -> np.ndarray:
    """Block j of a query stream: [QUERY_BLOCK, dim] float32 on the host,
    held out from the corpus (fresh noise), never equal across blocks."""
    rng = np.random.default_rng(sub_seed(seed, "queries", stream, j))
    pick = rng.integers(0, N_CENTRES, QUERY_BLOCK)
    noise = rng.standard_normal((QUERY_BLOCK, cent.shape[1]), dtype=np.float32)
    return cent[pick] + noise


def queries(seed: int, stream: int, index: np.ndarray, cent: np.ndarray) -> np.ndarray:
    """The queries of a stream at these positions, [len(index), dim]."""
    index = np.asarray(index, np.int64)
    out = np.empty((len(index), cent.shape[1]), np.float32)
    blocks = index // QUERY_BLOCK
    for j in np.unique(blocks):
        sel = blocks == j
        out[sel] = query_block(seed, stream, int(j), cent)[index[sel] % QUERY_BLOCK]
    return out


def deleted_ids(seed: int, n_rows: int, share: float) -> np.ndarray:
    """The ids deleted in set-up: round(share * n_rows) distinct ids, sorted."""
    n = int(round(share * n_rows))
    if n == 0:
        return np.zeros(0, np.int64)
    rng = np.random.default_rng(sub_seed(seed, "deleted"))
    return np.sort(rng.choice(n_rows, n, replace=False)).astype(np.int64)
