"""80th percentile of send-to-first-token over every request sent in the
window, kept per layer in the chat cell: the one cell that reads it, and
there its runs spread by more than half of the widest bound an end-to-end
metric may take (PERF.md).  A request is sent when a slot frees for it (a
closed loop); one whose first token never came leaves the metric out.  The
run's standard error gives the 90th beside it."""
from specbench.lib import serve

NAME, UNIT, SOURCE = "ttft_p80_ms.chat", "ms", "host_clock"
LAYER = "engine: admission"
MOVES = "tbt_p95_ms"


def read(run):
    return serve.ttft_ms(run, 80)
