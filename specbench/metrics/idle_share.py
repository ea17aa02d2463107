"""1 - (union of kernel and copy intervals) / (profiled window)."""
NAME, UNIT, SOURCE = "idle_share", "%", "device_trace"
LAYER = "device"
MOVES = "tokens_per_s"


def read(run):
    t = run.trace
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if t else None
