"""Multi-sequence odometry evaluation helpers: a copy of `vfmreg_tpu/kiss/eval.py`.

Counterpart of the reference's notebook toolkit
(`kiss-icp/eval/kiss_icp_eval.py:40-106`), which backs the
kitti / kitti_raw / mulran / newer_college regression notebooks: run a pipeline
factory over sequences while accumulating per-metric value lists and
trajectories, render the aggregate as a Markdown table, and plot estimated vs
ground-truth trajectories.

Dependency-free rebuild: the reference renders through IPython
`display_markdown` and plots through `evo`; here the table is returned (and
printed) as a plain Markdown string usable in or out of a notebook, and
trajectories draw with matplotlib directly — same top-down + xyz views the evo
defaults produce. The results-dict schema (`dataset_name`, `metrics`,
`trajectories`) is kept so existing notebook code ports unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np


@dataclass
class Metric:
    """Per-metric unit + one value per evaluated sequence (reference `:34-37`)."""

    units: str
    values: List = field(default_factory=list)


def run_sequence(kiss_pipeline: Callable, results: Dict, **kwargs) -> None:
    """Run one sequence through a pipeline factory and fold its metrics and
    trajectory into `results` (reference `kiss_icp_eval.py:40-65`).

    `kiss_pipeline(sequence)` must return an `OdometryPipeline`-like object
    (`vfmreg_tpu_torch.kiss.pipeline.OdometryPipeline` qualifies): `run()` returning
    a `PipelineResults`, plus `dataset_name`, `dataset_sequence`, `gt_poses`,
    and `poses` attributes.
    """
    pipeline = kiss_pipeline(kwargs.pop("sequence"))

    results.setdefault("dataset_name", pipeline.dataset_name)

    print(f"Now evaluating sequence {pipeline.dataset_sequence}")
    seq_res = pipeline.run()
    print(seq_res)

    metrics = results.setdefault("metrics", {})
    for desc, units, value in seq_res.items():
        metrics.setdefault(desc, Metric(units)).values.append(value)

    results.setdefault("trajectories", {})[pipeline.dataset_sequence] = {
        "gt_poses": np.asarray(pipeline.gt_poses) if pipeline.gt_poses is not None else None,
        "poses": np.asarray(pipeline.poses).reshape(len(pipeline.poses), 4, 4),
    }


def metrics_table(results: Dict, title: str = "") -> str:
    """The aggregate Markdown metrics table (reference `:68-74`): one row per
    metric, value = mean over the evaluated sequences."""
    table = f"# Experiment Results {title}\n|Metric|Value|Units|\n|-:|:-:|:-|\n"
    for metric, result in results.get("metrics", {}).items():
        table += f"{metric}| {np.mean(result.values):.2f}|{result.units} |\n"
    return table


def print_metrics_table(results: Dict, title: str = "") -> None:
    """Print (reference: display into the notebook) the aggregate table."""
    print(metrics_table(results, title))


def plot_trajectories(
    results: Dict,
    close_all: bool = True,
    output_dir: Optional[str] = None,
    show: bool = False,
):
    """Estimated vs ground-truth trajectory plots (reference `:77-106`).

    One figure per sequence: a 3D xyz view (the reference's
    `plot.PlotMode.xyz`) with the ground truth dashed gray and the estimate
    solid blue. With `output_dir`, each figure is also written as
    `<sequence>_trajectory.png` (the headless equivalent of `plt.show()`).
    Returns the list of figures.
    """
    import matplotlib

    if not show:
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    if close_all:
        plt.close("all")
    figures = []
    name = results.get("dataset_name", "")
    for sequence, trajectory in results.get("trajectories", {}).items():
        fig = plt.figure(f"Trajectory results for {name} {sequence}")
        ax = fig.add_subplot(projection="3d")
        est = np.asarray(trajectory["poses"])[:, :3, 3]
        gt = trajectory.get("gt_poses")
        if gt is not None:
            gt = np.asarray(gt)[:, :3, 3]
            ax.plot(gt[:, 0], gt[:, 1], gt[:, 2], "--", color="gray", label="ground truth")
        ax.plot(est[:, 0], est[:, 1], est[:, 2], color="#4c72b0", alpha=0.75, label="KISS-ICP")
        ax.legend(frameon=True)
        ax.set_title(f"Sequence {sequence}")
        if output_dir is not None:
            fig.savefig(f"{output_dir}/{sequence}_trajectory.png", dpi=120)
        figures.append(fig)
    if show:
        plt.show()
    return figures
