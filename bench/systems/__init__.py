"""Part of the benchmark of repro_torch (see bench/run.py)."""
