"""Output tokens committed in the window, over all requests, per second of
the window (the first token of a request included)."""
NAME, UNIT, SOURCE = "tokens_per_s", "tokens/s", "host_clock"


def read(run):
    n = sum(1 for ts in run.stamps.values() for t in ts if run.in_window(t))
    return n / run.window_s
