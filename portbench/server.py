"""The system under test: the port's serving process, built as its
serve.py builds it (build_runtime: VectorStore, FlightHandlers,
coalescer, middleware, compaction), filled in process from the seed and
served by the port's Flight listeners on free loopback ports.
"""
from __future__ import annotations

import gc
import threading
import time

import numpy as np

from recipe import STREAM_WARM, centres, deleted_ids, query_block, rows


class Server:
    def __init__(self, cfg: dict, seed: int, device: str):
        self.cfg, self.seed, self.device = cfg, seed, device
        self.name = cfg["dataset"]
        self.parts: dict = {}
        self.threads: list = []

    def build(self) -> None:
        """The runtime, kernels built (its warm-up), before any data."""
        from longbow_tpu_torch.config import Config
        from longbow_tpu_torch.serve import build_runtime

        t = time.perf_counter()
        conf = Config(host="127.0.0.1", data_port=0, meta_port=0, metrics_port=0,
                      data_dir="", **self.cfg.get("server", {}))
        self.rt = build_runtime(conf, device=self.device)
        self.store = self.rt.store
        self.parts["runtime_s"] = time.perf_counter() - t

    def fill(self) -> None:
        """Put the rows as the configuration's deployment does, then
        delete its share of ids."""
        import torch

        t = time.perf_counter()
        cfg = self.cfg
        n, dim = cfg["rows"], cfg["dim"]
        self.store.get_or_create(self.name, dim, cfg.get("metric", "l2"),
                                 index_kind=cfg["index_kind"],
                                 index_params=cfg.get("index_params"))
        cent = torch.from_numpy(centres(self.seed, dim)).to(self.device)
        puts = cfg["puts"]
        bounds = [0, puts["first"], *range(puts["first"] + puts["each"], n - puts["last"],
                                           puts["each"]), n - puts["last"], n]
        bounds = sorted(set(min(max(x, 0), n) for x in bounds))
        for s, e in zip(bounds[:-1], bounds[1:]):
            self.store.put(self.name, np.arange(s, e, dtype=np.int64),
                           rows(self.seed, dim, s, e, cent))
        del cent
        self.scan_rows, self.scan_groups = self.scanned_rows(), self.groups()
        if self.device != "cpu":
            torch.cuda.synchronize()
        self.parts["data_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.deleted = deleted_ids(self.seed, n, cfg["deleted_share"])
        if len(self.deleted):
            self.store.delete(self.name, self.deleted)
        self.parts["delete_s"] = time.perf_counter() - t

    def scanned_rows(self) -> int:
        """Rows the cell's scan kernel reads a search: every stored row
        of a flat index, the main region of an sq8r index."""
        index = self.store.get(self.name).index
        inner = getattr(index, "_inner", index)
        if hasattr(inner, "d_count"):
            return int(inner.count - inner.d_count)
        return int(self.cfg["rows"])

    def groups(self) -> int:
        """K2's cluster groups in the main region (0 for other kinds)."""
        index = self.store.get(self.name).index
        gcid = getattr(getattr(index, "_inner", index), "m_gcid", None)
        return 0 if gcid is None else int(gcid.shape[0])

    def listen(self) -> None:
        from longbow_tpu_torch.serving.flight_server import LongbowFlightServer

        t = time.perf_counter()
        self.data = LongbowFlightServer(self.store, "grpc://127.0.0.1:0",
                                        handlers=self.rt.handlers)
        self.meta = LongbowFlightServer(self.store, "grpc://127.0.0.1:0",
                                        handlers=self.rt.handlers)
        for srv in (self.data, self.meta):
            th = threading.Thread(target=srv.serve, daemon=True)
            th.start()
            self.threads.append(th)
        self.parts["listen_s"] = time.perf_counter() - t

    def warm(self, sizes) -> None:
        """One search of each batch size the cell's traffic makes, with
        warm-up queries the window never sends."""
        t = time.perf_counter()
        k = self.cfg["k"]
        cent = centres(self.seed, self.cfg["dim"])
        need = max(sizes)
        qs = np.concatenate([query_block(self.seed, STREAM_WARM, 1_000 + j, cent)
                             for j in range(-(-need // 1_000))])
        self.store.get(self.name).warm()
        for b in sizes:
            self.store.search(self.name, qs[:b], k, use_cache=False)
        self.parts["warm_in_process_s"] = time.perf_counter() - t

    def stop(self) -> None:
        """Stop the listeners and the runtime, and free the store's device
        memory."""
        for srv in (getattr(self, "data", None), getattr(self, "meta", None)):
            if srv is not None:
                srv.shutdown()
        for th in self.threads:
            th.join(timeout=10)
        rt = getattr(self, "rt", None)
        if rt is not None:
            from longbow_tpu_torch.metrics import get_registry

            if self.name in rt.store.list_datasets():
                rt.store.drop(self.name)
            rt.close()
            get_registry().health_fn = None  # its checks hold the store
        self.rt = self.store = self.data = self.meta = None
        gc.collect()
        if self.device != "cpu":
            import torch

            torch.cuda.synchronize()
            torch.cuda.empty_cache()
