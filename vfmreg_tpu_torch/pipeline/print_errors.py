"""Results post-processor: a numpy copy of `vfmreg_tpu/pipeline/print_errors.py:18-108`.

Reads the pickled error dicts that `RegistrationNode.dump_errors` writes,
writes the LaTeX-ish `error.txt` rows of the paper's table, and prints the
mean / median / success-conditioned error tables and the three-threshold
recall table. Run on a pickle, or on a folder of them:

    python -m vfmreg_tpu_torch.pipeline.print_errors FOLDER/errors_<date>/mode.pkl
"""

from __future__ import annotations

import argparse
import pickle
from pathlib import Path

import numpy as np

from vfmreg_tpu_torch.geometry.metrics import success_rate as compute_success_rate


def main(file: Path, error_txt_dir: Path = None) -> dict:
    with open(file, "rb") as f:
        data = pickle.load(f)

    rot_errors = {k: np.array(v) for k, v in data["rot"].items()}
    trans_errors = {k: np.array(v) for k, v in data["trans"].items()}

    # Primary success: RTE < 0.6 m and RRE < 1.5 deg (`print_errors.py:32`).
    success = {
        m: np.logical_and(trans_errors[m] < 0.6, rot_errors[m] < 1.5) for m in rot_errors
    }

    error_string = ""
    for method, rot_error in rot_errors.items():
        if "icp" in method and "vfm" not in method:
            continue
        trans_error = trans_errors[method]
        recall = success[method]
        error_string += (
            f"{method}\t{np.round(np.mean(trans_error), 2):.2f}"
            f"$\\pm${np.round(np.std(trans_error), 2):.2f}"
        )
        error_string += (
            f" & {np.round(np.mean(rot_error), 2):.2f}"
            f"$\\pm${np.round(np.std(rot_error), 2):.2f}"
        )
        error_string += f" & {np.round(np.mean(recall) * 100, 2):.2f}"
        recall = success.get(f"{method}_icp", recall)
        error_string += f" & {np.round(np.mean(recall) * 100, 2):.2f}"
        error_string += "\n"
    out_dir = Path(error_txt_dir) if error_txt_dir else Path(file).parent
    with open(out_dir / "error.txt", "w") as f:
        f.write(error_string)

    print("=" * 80)
    for method, rot_error in rot_errors.items():
        s = f"Rotation error ({method:<20}): {np.mean(rot_error):.3f} ± {np.std(rot_error):.3f}"
        s = f"{s:<57}" + f" | {np.median(rot_error):.3f}"
        if success[method].any():
            s = (
                f"{s:<67}"
                + f" | {rot_error[success[method]].mean():.3f} ± {rot_error[success[method]].std():.3f}"
            )
        print(s)
    print("-" * 80)
    for method, trans_error in trans_errors.items():
        s = f"Translat error ({method:<20}): {np.mean(trans_error):.3f} ± {np.std(trans_error):.3f}"
        s = f"{s:<57}" + f" | {np.median(trans_error):.3f}"
        if success[method].any():
            s = (
                f"{s:<67}"
                + f" | {trans_error[success[method]].mean():.3f} ± {trans_error[success[method]].std():.3f}"
            )
        print(s)
    print("-" * 80)
    thresholds = [(0.3, 15), (0.6, 1.5), (2, 5)]
    header = f"{'':<20}: "
    for t in thresholds:
        header += f"{t[0]:>3}, {t[1]:<3} | "
    print(header[:-2])
    recalls = {}
    for method, rot_error in rot_errors.items():
        trans_error = trans_errors[method]
        row = f"{method:<20}: "
        recalls[method] = {}
        for t in thresholds:
            r = 100 * compute_success_rate(trans_error, rot_error, *t)
            recalls[method][t] = r
            row += f"{r:>8.2f} | "
        print(row[:-2])
    print("=" * 80)
    return recalls


def cli(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("file", type=str)
    args = parser.parse_args(argv)
    file = Path(args.file)
    if file.suffix == ".pkl":
        main(file)
    elif file.is_dir():
        for f in sorted(file.iterdir()):
            print(f"File: {f.name}")
            main(f)
    else:
        raise ValueError("Invalid file")


if __name__ == "__main__":
    cli()
