"""Summed least time over summed device time of every paged flash and paged
tree call in the profiled window (``lib/counts.py``: bytes once at the HBM
rate, three TF32 products per fp32 product at the TF32 rate).  Nothing is
read when the kernels the profiler saw are not the calls the wrapper saw."""
NAME, UNIT, SOURCE = "attn_roofline", "%", "device_trace"
LAYER = ("kernels: kernels/paged.py, csrc/flash_attention_lse.cu, "
         "csrc/tree_block_attention.cu")
MOVES = "tokens_per_s"


def read(run):
    t = run.trace
    if not t or not run.attn_calls or t["paged_kernels"] != run.attn_calls:
        return None
    return 100.0 * run.attn_least_s / t["paged_device_s"]
