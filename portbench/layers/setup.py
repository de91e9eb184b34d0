"""Set-up, by part: setup.<part> is the seconds that part of this run's
set-up took (run.py's setup_parts: before_runtime_s from process start
to the runtime's build, the interpreter, torch and the CUDA context;
data_s the rows made and put through the store; warm_flight_s the
callers' first requests through the Flight edge)."""


def read(ctx: dict, metric: str):
    return ctx.get("setup_parts", {}).get(metric.split(".", 1)[1])
