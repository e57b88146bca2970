"""The benchmark of pbrl_tpu_torch on one H100: run a cell with ``python3 -m benchmark.run``."""
