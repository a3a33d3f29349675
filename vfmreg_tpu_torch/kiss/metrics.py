"""kiss_icp.metrics-compatible names (`python/kiss_icp/metrics.py`)."""

from vfmreg_tpu_torch.geometry.metrics import absolute_trajectory_error  # noqa: F401
from vfmreg_tpu_torch.geometry.metrics import seq_error as sequence_error  # noqa: F401
