"""Model FLOPs of the useful rows (valid tree nodes of both verifies and
every prompt token of both prefills, a sparse layer's token at the experts
it reaches) over the window's seconds at the published IEEE-fp32 peak.
Padding, empty slot rows and capacity rows count nothing."""
from specbench.lib import counts

NAME, UNIT, SOURCE = "step_mfu", "%", "program_counter"
LAYER = "model step: models/transformer.py, attention.py, moe.py, layers.py"
MOVES = "tokens_per_s"


def read(run):
    from specbench.lib.serve import untraced
    rows = untraced(run)
    total = sum(dt for dt, _ in rows)
    if not total or not run.device.startswith("cuda"):
        return None
    return 100.0 * sum(s.flops for _, s in rows) / (
        total * counts.FP32_FLOP_PER_S)
