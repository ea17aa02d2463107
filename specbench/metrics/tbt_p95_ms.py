"""95th percentile of the gaps between consecutive committed tokens of one
request, over every gap of every request that ends in the window."""
import numpy as np

NAME, UNIT, SOURCE = "tbt_p95_ms", "ms", "host_clock"


def read(run):
    gaps = [b - a for ts in run.stamps.values() for a, b in zip(ts, ts[1:])
            if run.in_window(b)]
    return 1e3 * float(np.percentile(gaps, 95)) if gaps else None
