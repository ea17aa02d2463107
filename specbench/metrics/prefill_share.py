"""Share of the window spent inside the executor's admission prefill, timed
by the harness's wrapper with a sync at each end (traced runs only; the
traced timesteps left out)."""
NAME, UNIT, SOURCE = "prefill_share", "%", "program_span"
LAYER = "engine: admission"
MOVES = "tbt_p95_ms"


def read(run):
    from specbench.lib.serve import untraced
    rows = untraced(run)
    total = sum(dt for dt, _ in rows)
    return 100.0 * sum(s.prefill_s for _, s in rows) / total if total else None
