"""Most device memory allocated in the window (peak statistics reset at its
start), in GiB."""
NAME, UNIT, SOURCE = "peak_mem_gib", "GiB", "program_counter"
LAYER = "device"
MOVES = "tokens_per_s"


def read(run):
    return run.peak_window_bytes / 2 ** 30 if run.peak_window_bytes else None
