"""One caller of the load generator: a process of its own, a client of
the Flight server.

    python portbench/loadgen.py

reads a plan (one JSON line) on standard input, connects to the server
with the port's LongbowClient, warms up, prints {"ready": ...}, waits
for a line "go", drives the window, writes what it received to the
plan's `out` (npz) and prints {"done": ...}. It imports numpy, pyarrow
and the port's client: no torch, and nothing touches the card.

The mix (the plan's "mix", from portbench/mixes/) is a closed loop of
`callers` such processes, so that no caller waits on another's
interpreter lock. Caller c of C sends requests c, c + C, c + 2C, ...,
each of `batch` fresh queries (request r: queries r*batch to
(r+1)*batch - 1 of the window's stream), the next when its answer
arrives; the client sends a batch of 256 or more by DoExchange. Every
request is timed from its send. A thread of the process makes the next
requests' queries while the caller waits on the server.
"""
from __future__ import annotations

import json
import os
import queue
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from recipe import STREAM_WARM, STREAM_WINDOW, centres, queries, sub_seed  # noqa: E402

LATE_WAIT_S = 60.0  # a request's timeout: an answer is awaited this long
AHEAD = 8  # requests whose queries are made before they are sent


def answer_arrays(tbl, b: int, k: int) -> tuple[np.ndarray, np.ndarray]:
    """A search answer table {query_index, id, score} -> (ids [b, k] int64
    with -1 where a query had fewer rows, scores [b, k] f32 with nan)."""
    ids = np.full((b, k), -1, np.int64)
    scores = np.full((b, k), np.nan, np.float32)
    if tbl.num_rows == 0:
        return ids, scores
    qi = tbl.column("query_index").to_numpy().astype(np.int64)
    order = np.argsort(qi, kind="stable")
    qi = qi[order]
    starts = np.searchsorted(qi, np.arange(b))
    pos = np.arange(len(qi)) - starts[qi]
    keep = (pos < k) & (qi < b)
    ids[qi[keep], pos[keep]] = tbl.column("id").to_numpy()[order][keep]
    scores[qi[keep], pos[keep]] = tbl.column("score").to_numpy()[order][keep]
    return ids, scores


def request_queries(seed: int, stream: int, r: int, b: int, cent: np.ndarray) -> np.ndarray:
    """The queries of request r: positions r*b .. (r+1)*b - 1 of a stream."""
    return queries(seed, stream, np.arange(r * b, (r + 1) * b), cent)


def check_sample(seed: int, caller: int, answered: np.ndarray, n: int) -> np.ndarray:
    """n of a caller's answered requests, drawn from the seed, sorted."""
    rng = np.random.default_rng(sub_seed(seed, "check", caller))
    return np.sort(rng.permutation(answered)[:n])


class Caller:
    def __init__(self, plan: dict):
        from longbow_tpu_torch.serving.client import LongbowClient

        self.plan = plan
        self.seed, self.mix = plan["seed"], plan["mix"]
        self.k, self.b = int(self.mix["k"]), int(self.mix["batch"])
        self.c, self.n_callers = int(plan["caller"]), int(self.mix["callers"])
        self.cent = centres(self.seed, plan["dim"])
        self.client = LongbowClient(plan["host"], plan["port"], plan["meta_port"],
                                    call_timeout_s=LATE_WAIT_S).connect()

    def search(self, qs: np.ndarray):
        return self.client.search(self.plan["dataset"], vector=qs, k=self.k)

    def warm(self) -> None:
        """warm_requests requests of warm-up queries the window never
        sends, then the window's first queries made."""
        for j in range(int(self.mix["warm_requests"])):
            r = j * self.n_callers + self.c
            answer_arrays(self.search(request_queries(self.seed, STREAM_WARM, r, self.b,
                                                      self.cent)), self.b, self.k)
        self.ahead: queue.Queue = queue.Queue(maxsize=AHEAD)
        self._stop = threading.Event()
        self._maker = threading.Thread(target=self._make, daemon=True)
        self._maker.start()
        while not self.ahead.full():
            time.sleep(0.01)

    def _make(self) -> None:
        j = 0
        while not self._stop.is_set():
            r = j * self.n_callers + self.c
            item = (r, request_queries(self.seed, STREAM_WINDOW, r, self.b, self.cent))
            while not self._stop.is_set():
                try:
                    self.ahead.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            j += 1

    def run(self, seconds: float) -> dict:
        """The window: requests until `seconds` have passed since go."""
        b, k = self.b, self.k
        req, send, done, ok, answers, errors = [], [], [], [], {}, []
        cpu0 = time.process_time()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            r, qs = self.ahead.get()
            ts = time.perf_counter() - t0
            try:
                ids, sc = answer_arrays(self.search(qs), b, k)
                good = True
            except Exception as e:  # a failed request counts as not answered
                good, ids, sc = False, None, None
                errors.append(repr(e)[:300])
            td = time.perf_counter() - t0
            req.append(r), send.append(ts), done.append(td), ok.append(good)
            if good:
                answers[r] = (ids.astype(np.int32), sc)
        cpu = time.process_time() - cpu0
        self._stop.set()
        self._maker.join()
        req, send, done = np.array(req, np.int64), np.array(send), np.array(done)
        ok = np.array(ok, bool)
        # the answers judged: a seeded sample of the requests answered in
        # the window, this caller's share of check_queries
        share = -(-int(self.mix["check_queries"]) // (b * self.n_callers))
        pick = check_sample(self.seed, self.c, req[ok & (done <= seconds)], max(share, 1))
        return {
            "request": req, "send": send, "done": done, "ok": ok,
            "queries_per_request": np.int64(b), "cpu_s": np.float64(cpu),
            "check_request": pick,
            "check_ids": (np.concatenate([answers[r][0] for r in pick]).astype(np.int64)
                          if len(pick) else np.zeros((0, k), np.int64)),
            "check_scores": (np.concatenate([answers[r][1] for r in pick])
                             if len(pick) else np.zeros((0, k), np.float32)),
            "errors": np.array(errors[:20], dtype=object).astype(str),
        }


def main() -> int:
    plan = json.loads(sys.stdin.readline())
    caller = Caller(plan)
    caller.warm()
    print(json.dumps({"ready": True}), flush=True)
    if sys.stdin.readline().strip() != "go":
        return 1
    out = caller.run(float(plan["seconds"]))
    np.savez(plan["out"], **out)
    print(json.dumps({"done": True}), flush=True)
    caller.client.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
