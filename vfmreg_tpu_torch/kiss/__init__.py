"""The KISS-ICP-compatible odometry layer (`kiss_icp`'s public Python
surface): host voxel downsampling, the voxel hash map, `register_frame`, the
adaptive threshold, `KissICP` and `OdometryPipeline` (see each module)."""

from vfmreg_tpu_torch.kiss.voxelization import voxel_down_sample  # noqa: F401
from vfmreg_tpu_torch.kiss.mapping import VoxelHashMap, get_voxel_hash_map  # noqa: F401
from vfmreg_tpu_torch.kiss.registration import register_frame  # noqa: F401
from vfmreg_tpu_torch.kiss.threshold import AdaptiveThreshold, get_threshold_estimator  # noqa: F401
from vfmreg_tpu_torch.kiss.kiss_icp import KissICP  # noqa: F401
