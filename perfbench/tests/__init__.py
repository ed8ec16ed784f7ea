"""CPU tests of the benchmark (and its card tests, skipped here)."""
