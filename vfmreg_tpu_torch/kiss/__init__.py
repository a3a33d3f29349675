"""The KISS-ICP-compatible layer the evaluation driver uses: host voxel
downsampling, the voxel hash map and `register_frame` (see each module)."""

from vfmreg_tpu_torch.kiss.voxelization import voxel_down_sample  # noqa: F401
from vfmreg_tpu_torch.kiss.mapping import VoxelHashMap, get_voxel_hash_map  # noqa: F401
from vfmreg_tpu_torch.kiss.registration import register_frame  # noqa: F401
