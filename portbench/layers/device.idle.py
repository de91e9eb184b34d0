"""Device: the share of the traced window in which no operation ran on
the card (torch.profiler in the server's process), as a ratio. Reads
every device.idle.<suffix>; nothing where the trace holds no device
activity."""


def read(ctx: dict, metric: str):
    tr = ctx.get("trace")
    if not tr or tr["busy_s"] <= 0 or tr["window_s"] <= 0:
        return None
    return 1.0 - tr["busy_s"] / tr["window_s"]
