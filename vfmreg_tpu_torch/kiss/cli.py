"""Odometry CLI: counterpart of `vfmreg_tpu/kiss/cli.py` (the reference's
`kiss_icp/tools/cmd.py`) on argparse, on the card unless `--device cpu`.

    python -m vfmreg_tpu_torch.kiss.cli DATA_DIR [--dataloader generic] [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

from vfmreg_tpu_torch.kiss.datasets import dataset_factory
from vfmreg_tpu_torch.kiss.pipeline import OdometryPipeline


def main(argv=None):
    parser = argparse.ArgumentParser(description="vfmreg_tpu_torch odometry pipeline")
    parser.add_argument("data_dir", type=str)
    parser.add_argument("--dataloader", default="generic", type=str)
    parser.add_argument("--sequence", default=0)
    parser.add_argument("--config", default=None, type=str)
    parser.add_argument("--deskew", action="store_true")
    parser.add_argument("--max-range", default=None, type=float)
    parser.add_argument("--n-scans", default=-1, type=int)
    parser.add_argument("--jump", default=0, type=int)
    parser.add_argument(
        "--use-descriptors", action="store_true",
        help="Keep descriptor columns through voxelization and register on the XD "
        "cosine-weighted path (the reference odometry server's v2 mode); by "
        "default extra columns are dropped, as in v0 / v1.",
    )
    parser.add_argument("--device", default=None, type=str,
                        help="torch device (default: the CUDA card; 'cpu' runs the plain versions)")
    args = parser.parse_args(argv)

    if args.dataloader == "kitti":
        dataset = dataset_factory(args.dataloader, Path(args.data_dir), int(args.sequence))
    elif args.dataloader == "nclt":
        dataset = dataset_factory(args.dataloader, Path(args.data_dir), str(args.sequence))
    else:
        dataset = dataset_factory(args.dataloader, Path(args.data_dir))

    pipeline = OdometryPipeline(
        dataset,
        config=Path(args.config) if args.config else None,
        deskew=args.deskew,
        max_range=args.max_range,
        n_scans=args.n_scans,
        jump=args.jump,
        use_descriptors=args.use_descriptors,
        device=args.device,
    )
    results = pipeline.run()
    print(results)
    return results


if __name__ == "__main__":
    main()
