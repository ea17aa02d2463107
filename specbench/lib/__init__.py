"""The harness: command, run, traffic, weights, check, counts, trace."""
