"""CPU tests of the benchmark harness (and one card test)."""
