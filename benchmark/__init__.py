"""The benchmark of vfmreg_tpu_torch (see `harness.py`)."""
