"""Flight edge (serving/flight_server.py, flight_handlers.py, client.py):
the mean client-observed time of the window's requests less the mean time
inside the handler entry that served them (DoGet for a ticket, DoExchange
for a batch the client streams), in ms. Reads every edge.added_ms.<suffix>."""
import numpy as np


def read(ctx: dict, metric: str):
    spans, c, sec = ctx.get("spans"), ctx["client"], ctx["seconds"]
    if spans is None:
        return None
    sel = c["ok"] & (c["send"] >= 0) & (c["send"] <= sec)
    inside = [t1 - t0 for _, t0, t1 in spans["handler"] if 0 <= t0 <= sec]
    if not sel.any() or not inside:
        return None
    return 1e3 * (float(np.mean(c["done"][sel] - c["send"][sel])) - float(np.mean(inside)))
