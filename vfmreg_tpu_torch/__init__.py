"""PyTorch / NVIDIA H100 port of `vfmreg_tpu`.

A second package beside the JAX reference. Plain tensor code is PyTorch; each
Pallas kernel of the reference is a CUDA C++ kernel for Hopper (`csrc/`),
built with `nvcc` at first use and bound with `ctypes` (`ops/_build.py`). Every kernel wrapper keeps a plain PyTorch version of the
same function, which it runs only for CPU tensors (the tests); for CUDA
tensors it launches the kernel or raises.

The package imports torch, numpy, scipy and the standard library (`h5py`
inside `data.h5io`'s functions, where a scene file is read or written;
`cv2` and `PIL` inside the dataset loaders' image readers, `data.nclt`,
`data.oxford_robotcar`, `data.kitti_odometry`, `data.robotcar_sdk`;
`yaml` inside `config`'s file readers and writers; `matplotlib` inside
`kiss.eval.plot_trajectories`). Entry points (`scan_to_map.scan_to_map`,
`pipeline.registration_node.precompute_scene_batched` and
`.RegistrationNode`, `models.image_features.ImageFeatureGenerator` (DINOv2
or MaskCLIP, FeatUp, CLIP's text tower) for
`pipeline.prepare_scenes.create_descriptors`, `.prepare_scene` and its
CLI, `convert.grid_from_numpy`,
`kiss.KissICP`, `kiss.pipeline.OdometryPipeline` and `kiss.cli`,
`pipeline.transform_server`) run on the card unless the caller passes
`device="cpu"`.
"""
