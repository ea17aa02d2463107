"""Process start to the first timed timestep: kernel build (first run of a
checkout only), weights, the program's set-up and the first admission."""
NAME, UNIT, SOURCE = "setup_s", "s", "host_clock"


def read(run):
    return run.setup_s
