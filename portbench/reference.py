"""The plain reference and the comparison that decides `correct`.

The reference makes the configuration's rows again from the seed,
leaves out the deleted ids and finds each query's exact top-k in float32
with TF32 off, a block of rows at a time; the candidates are then ranked
again by float64 distances. The comparison holds what the client received
against it (judge()). The control (control_answers()) is the reference
put in the program's place in the precision below the one the
configuration states.

Imports torch, numpy and the benchmark's recipe: nothing of the program.
"""
from __future__ import annotations

import numpy as np
import torch

from recipe import centres, rows

ROWS_AT_ONCE = 1 << 20
QUERIES_AT_ONCE = 1024
CAND = 4  # the f32 pass keeps CAND * k candidates for the float64 ranking


def _plain_matmul():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _row_blocks(seed: int, cfg: dict, device, transform=None):
    """(start, rows f32 [n, D]) over the corpus; transform(rows, assign)
    replaces the rows (the control's quantization)."""
    cent = torch.from_numpy(centres(seed, cfg["dim"])).to(device)
    n = cfg["rows"]
    for s in range(0, n, ROWS_AT_ONCE):
        e = min(s + ROWS_AT_ONCE, n)
        if transform is None:
            yield s, rows(seed, cfg["dim"], s, e, cent)
        else:
            r, a = rows(seed, cfg["dim"], s, e, cent, with_assign=True)
            yield s, transform(r, a, cent)


def _exact_search(blocks, qs: np.ndarray, deleted: np.ndarray, k: int, device):
    """Exact top-k ids [M, k] and float64 distances over the row blocks,
    deleted ids left out."""
    _plain_matmul()
    q = torch.from_numpy(np.ascontiguousarray(qs, np.float32)).to(device)
    m, c = q.shape[0], CAND * k
    best_d = torch.full((m, c), float("inf"), device=device)
    best_i = torch.full((m, c), -1, dtype=torch.int64, device=device)
    dead = torch.from_numpy(np.asarray(deleted, np.int64)).to(device)
    qn = (q * q).sum(1)
    for s, r in blocks:
        n = r.shape[0]
        alive = torch.ones(n, dtype=torch.bool, device=device)
        local = dead[(dead >= s) & (dead < s + n)] - s
        alive[local] = False
        rn = torch.where(alive, (r * r).sum(1), torch.full((n,), float("inf"), device=device))
        for a in range(0, m, QUERIES_AT_ONCE):
            b = min(a + QUERIES_AT_ONCE, m)
            d = qn[a:b, None] - 2.0 * (q[a:b] @ r.T) + rn[None, :]
            dv, di = torch.topk(d, min(c, n), dim=1, largest=False)
            cd = torch.cat([best_d[a:b], dv], 1)
            ci = torch.cat([best_i[a:b], di + s], 1)
            top = torch.topk(cd, c, dim=1, largest=False)
            best_d[a:b] = top.values
            best_i[a:b] = torch.gather(ci, 1, top.indices)
    return q, best_i


def _distances64(blocks, q: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """float64 squared l2 of each query to each of its ids [M, c] (inf
    where an id is < 0 or past the rows)."""
    out = torch.full(ids.shape, float("inf"), dtype=torch.float64, device=q.device)
    q64 = q.double()
    for s, r in blocks:
        n = r.shape[0]
        sel = (ids >= s) & (ids < s + n)
        if not bool(sel.any()):
            continue
        qi, ci = torch.nonzero(sel, as_tuple=True)
        diff = q64[qi] - r[ids[qi, ci] - s].double()
        out[qi, ci] = (diff * diff).sum(1)
    return out


def exact_topk(seed: int, cfg: dict, qs: np.ndarray, deleted: np.ndarray, k: int,
               device, transform=None) -> tuple[np.ndarray, np.ndarray]:
    """-> (ids [M, k] int64, float64 squared l2 [M, k]), ascending, over
    the live rows (transformed, for the control)."""
    blocks = lambda: _row_blocks(seed, cfg, device, transform)  # noqa: E731
    q, cand = _exact_search(blocks(), qs, deleted, k, device)
    d64 = _distances64(blocks(), q, cand)
    order = torch.argsort(d64, dim=1, stable=True)[:, :k]
    ids = torch.gather(cand, 1, order)
    return ids.cpu().numpy(), torch.gather(d64, 1, order).cpu().numpy()


def true_distances(seed: int, cfg: dict, qs: np.ndarray, ids: np.ndarray, device) -> np.ndarray:
    """float64 squared l2 of each query to the f32 rows of its ids [M, k]
    (inf where an id is not a row)."""
    q = torch.from_numpy(np.ascontiguousarray(qs, np.float32)).to(device)
    t = torch.from_numpy(np.asarray(ids, np.int64)).to(device)
    return _distances64(_row_blocks(seed, cfg, device), q, t).cpu().numpy()


# -- the control ------------------------------------------------------------

def _affine_bounds(seed: int, cfg: dict, device, residual: bool):
    lo = hi = None
    for _, r in _row_blocks(seed, cfg, device,
                            (lambda x, a, c: x - c[a]) if residual else None):
        bl, bh = r.min(0).values, r.max(0).values
        lo = bl if lo is None else torch.minimum(lo, bl)
        hi = bh if hi is None else torch.maximum(hi, bh)
    return lo, hi


def control_transform(seed: int, cfg: dict, device):
    """The rows as the control stores them: each dim's affine over all
    rows to cfg["control"]["bits"] bits, of the residual to the row's
    recipe centre where cfg["control"]["residual"], dequantized."""
    spec = cfg["control"]
    residual = bool(spec.get("residual"))
    levels = float(2 ** int(spec["bits"]) - 1)
    lo, hi = _affine_bounds(seed, cfg, device, residual)
    step = torch.clamp((hi - lo) / levels, min=1e-12)

    def transform(r, assign, cent):
        base = cent[assign] if residual else 0.0
        codes = torch.round((r - base - lo) / step).clamp(0, levels)
        return base + lo + codes * step

    return transform


def control_answers(seed: int, cfg: dict, qs: np.ndarray, deleted: np.ndarray, k: int,
                    device) -> tuple[np.ndarray, np.ndarray]:
    """The control's answers: (ids [M, k], float32 scores [M, k]), its
    scores the distances to its own dequantized rows."""
    ids, d = exact_topk(seed, cfg, qs, deleted, k, device,
                        control_transform(seed, cfg, device))
    return ids, d.astype(np.float32)


# -- the comparison -----------------------------------------------------------

def judge(ids: np.ndarray, scores: np.ndarray, ref_ids: np.ndarray, ref_d: np.ndarray,
          true_d: np.ndarray, deleted: np.ndarray, n_rows: int) -> dict:
    """The numbers compared, over M answered queries.

    ids [M, k] int64 (-1 where the answer held fewer than k rows), scores
    [M, k] float32, ref_ids / ref_d the reference's top-k, true_d the
    float64 distance of each query to the f32 row of each returned id.
    wrong_answers: missing, duplicate, deleted or unknown ids; recall_short:
    1 - recall@k against the reference; score_err: the mean gap between a
    returned score and its row's true distance, over the query's k-th
    reference distance (score_err_max, the widest such gap, is reported
    beside it and not compared: the few rows a quantizer clamps set it)."""
    m, k = ref_ids.shape
    known = (ids >= 0) & (ids < n_rows)
    wrong = int((~known).sum())
    wrong += int(np.isin(ids[known], deleted).sum())
    srt = np.sort(np.where(known, ids, -1 - np.arange(k)[None, :]), axis=1)
    wrong += int((srt[:, 1:] == srt[:, :-1]).sum())
    hits = sum(len(np.intersect1d(ids[i][known[i]], ref_ids[i])) for i in range(m))
    recall = hits / float(m * k)
    scale = np.maximum(ref_d[:, -1:], 1e-30)
    gap = (np.abs(scores.astype(np.float64) - true_d) / scale)[known]
    gap = np.where(np.isfinite(gap), gap, 1.0)  # a missing score: a whole distance off
    return {"wrong_answers": wrong, "recall_short": 1.0 - recall,
            "score_err": float(gap.mean()) if gap.size else 1.0,
            "score_err_max": float(gap.max()) if gap.size else 1.0,
            "recall_at_10": recall, "queries": m}
