#!/usr/bin/env python3
"""Time kernel B4 (`nn_argmin`) of one copy of the port on one card.

    python3 profile_nn_argmin.py [--package-root DIR]

Imports `vfmreg_tpu_torch` from DIR (default: the directory of this
script), builds its `csrc/nn_argmin.cu` and runs `chip_smoke.check_nn_argmin`
on its wrapper: bit for bit against the plain version with a NaN query and
an empty neighbourhood, then the event, CUDA-graph and cold-L2 times. The
shapes are B4's five in `chip_smoke.py`: [32 x 16,384] (the slice's cache),
[32 x 8,192] (the driver's), [32 x 32,768] (the odometry's), the first cut
to 16,381 columns and the second to its first 7 rows, on caches seeded
with `chip_smoke.SEED`: coordinates N(0, 5 m), 30 % of the champions dead
(the sentinel), and rows 9 and 20 equal to rows 5 and 3 (ties within and
across the kernel's slices). To compare two copies on one card, unpack the
other tree under DIR and run the script in turns: other, this, this,
other. Prints one JSON line per shape, then the card's name and power
limit.
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--package-root", default=ROOT)
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs  # this script's own, before the package root goes first

    sys.path.insert(0, os.path.abspath(args.package_root))
    if not torch.cuda.is_available():
        print("profile_nn_argmin: CUDA is not available", file=sys.stderr)
        return 2
    from vfmreg_tpu_torch.ops.hash_grid import INVALID_COORD

    name = torch.cuda.get_device_name(0)
    peaks = cs.PEAKS["PCIe"] if "PCIe" in name else cs.PEAKS["SXM"]
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)

    def cache(n):
        dead = torch.rand(32, n, device="cuda", generator=g) < 0.3
        out = []
        for _ in range(3):
            c = torch.randn(32, n, device="cuda", generator=g) * 5.0
            c[dead] = INVALID_COORD
            c[9], c[20] = c[5], c[3]
            out.append(c)
        return out, torch.randn(n, 3, device="cuda", generator=g) * 5.0

    (slice_c, slice_q), (driver_c, driver_q), (odo_c, odo_q) = (cache(n) for n in (16384, 8192, 32768))
    cut = cs.NN_RAGGED_N
    cs.emit({"package_root": os.path.abspath(args.package_root)})
    cs.check_nn_argmin("slice", *slice_c, slice_q, peaks)
    cs.check_nn_argmin("driver", *driver_c, driver_q, peaks)
    cs.check_nn_argmin("odometry", *odo_c, odo_q, peaks)
    cs.check_nn_argmin("slice_ragged", *(c[:, :cut].contiguous() for c in slice_c), slice_q[:cut].contiguous(), peaks)
    cs.check_nn_argmin("driver_k7", *(c[: cs.NN_SMALL_K].contiguous() for c in driver_c), driver_q, peaks)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
