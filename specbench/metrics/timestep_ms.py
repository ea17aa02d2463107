"""Window seconds over the engine's timesteps executed in it (the traced
timesteps left out of a traced run)."""
NAME, UNIT, SOURCE = "timestep_ms", "ms", "host_clock"
LAYER = "engine: serving/dynbatch.py, serving/scheduler.py"
MOVES = "tokens_per_s"


def read(run):
    from specbench.lib.serve import untraced
    dts = [dt for dt, _ in untraced(run)]
    return 1e3 * sum(dts) / len(dts) if dts else None
