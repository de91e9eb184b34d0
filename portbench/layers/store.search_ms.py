"""Store (store/vector_store.py -> store/dataset.py -> index/flat.py or
index/sq8.py): the mean wall time of VectorStore.search a call that began
in the window (a coalesced dispatch where the coalescer groups), ending
with its answer on the host, in ms. Reads every store.search_ms.<suffix>."""


def read(ctx: dict, metric: str):
    spans, sec = ctx.get("spans"), ctx["seconds"]
    if spans is None:
        return None
    calls = [t1 - t0 for _, t0, t1 in spans["store"] if 0 <= t0 <= sec]
    return 1e3 * sum(calls) / len(calls) if calls else None
