"""CUDA kernel launches in the profiled window over its timesteps."""
NAME, UNIT, SOURCE = "launches_per_timestep", "launches", "device_trace"
LAYER = "executor: serving/executor.py LocalFusedExecutor"
MOVES = "tokens_per_s"


def read(run):
    t = run.trace
    return t["launches"] / t["timesteps"] if t and t["timesteps"] else None
