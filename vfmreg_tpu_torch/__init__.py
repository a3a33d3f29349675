"""PyTorch / NVIDIA H100 port of `vfmreg_tpu`.

A second package beside the JAX reference. Plain tensor code is PyTorch; each
Pallas kernel of the reference on the ported path is a CUDA C++ kernel for
Hopper (`csrc/`), built with `nvcc` at first use and bound with `ctypes`
(`ops/_build.py`). Every kernel wrapper keeps a plain PyTorch version of the
same function, which it runs only for CPU tensors (the tests); for CUDA
tensors it launches the kernel or raises.

The package imports torch, numpy and the standard library only. Entry points
(`scan_to_map.scan_to_map`, `convert.grid_from_numpy`) run on the card unless
the caller passes `device="cpu"`.
"""
