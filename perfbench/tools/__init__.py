"""Tools that run beside the benchmark: the readings its limits are set from."""
