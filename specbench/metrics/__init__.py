"""One reader per metric, found by file name from BENCHMARK.json."""
