"""Baseline checkpoints: where they go, their pinning, and their conversion.

Counterpart of the conversion part of `vfmreg_tpu/pipeline/download_models.py`
(the reference's `download_baseline_models.py`): the table of the six
baseline checkpoints, the DINOv2 backbone and CLIP's files (`CHECKPOINTS`:
file name, published source, the environment variable its loader reads),
the cache directory ($VFMREG_CACHE, else ~/.cache/vfmreg_tpu), the sha256
manifest that pins each file on its first verification, the structural
check of a checkpoint's tensor keys and shapes against the in-tree
reference goldens (`tests/golden/<name>_reference_golden.npz`), `export_env`
and `verify_loadable` through the port's loaders.

Fetching needs the network and is not part of the port, which only
converts: place the files in the cache directory, then

    python -m vfmreg_tpu_torch.pipeline.download_models [--dest DIR] [--verify]

prints the `export` lines of the files present and names the missing ones;
`--verify` pins and converts every present file.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
from pathlib import Path

import numpy as np

CHECKPOINTS = {
    # name: (file name, published source, environment variable of its loader)
    "fcgf": (
        "2019-07-31_19-37-00.pth",
        "https://node1.chrischoy.org/data/publications/fcgf/2019-07-31_19-37-00.pth",
        "VFMREG_FCGF_WEIGHTS",
    ),
    "dip": ("final_chkpt.pth", "gdrive:1wMaFrTJUCAQIqsye5hD7OJD2Vmq8hL6x", "VFMREG_DIP_WEIGHTS"),
    "gedi": ("chkpt.tar", "gdrive:1Ngvr1NYcDuD1LsYRYpuuMBmoY8DSpVcH", "VFMREG_GEDI_WEIGHTS"),
    "gcl": ("kitti_chkpt.pth", "gdrive:1wJ5tW8g3pLtS1PZ1bVSvXwqNDJ7rwjMk", "VFMREG_GCL_WEIGHTS"),
    "spinnet": (
        "KITTI_best.pkl",
        "https://github.com/QingyongHu/SpinNet/raw/main/pretrain/KITTI_best.pkl",
        "VFMREG_SPINNET_WEIGHTS",
    ),
    "pointdsc": (
        "model_best.pkl",
        "https://github.com/XuyangBai/PointDSC/raw/master/snapshot/PointDSC_KITTI_release/models/model_best.pkl",
        "VFMREG_POINTDSC_WEIGHTS",
    ),
    "dinov2": (
        "dinov2_vits14_pretrain.pth",
        "https://dl.fbaipublicfiles.com/dinov2/dinov2_vits14/dinov2_vits14_pretrain.pth",
        "VFMREG_DINOV2_WEIGHTS",
    ),
    "clip_bpe": (
        "bpe_simple_vocab_16e6.txt.gz",
        "https://github.com/openai/CLIP/raw/main/clip/bpe_simple_vocab_16e6.txt.gz",
        "VFMREG_CLIP_BPE",
    ),
    "clip_vitb16": (
        "ViT-B-16.pt",
        "https://openaipublic.azureedge.net/clip/models/5806e77cd80f8b59890b7e101eabd078d9fb84e6937f9e85e4ecb61988df416f/ViT-B-16.pt",
        "VFMREG_CLIP_WEIGHTS",
    ),
}

MANIFEST_NAME = "manifest.json"

# The key under which a raw checkpoint file holds the model state dict that
# the goldens pin (the loaders unwrap the same way).
_SD_UNWRAP = {"fcgf": "state_dict", "gcl": "state_dict", "gedi": "pnet_model_state_dict"}


def cache_dir() -> Path:
    return Path(os.environ.get("VFMREG_CACHE", Path.home() / ".cache" / "vfmreg_tpu"))


def file_sha256(path: Path, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for b in iter(lambda: f.read(chunk), b""):
            h.update(b)
    return h.hexdigest()


def load_manifest(dest: Path) -> dict:
    p = Path(dest) / MANIFEST_NAME
    if p.exists():
        with open(p) as f:
            return json.load(f)
    return {}


def check_and_pin_manifest(dest: Path, name: str, target: Path) -> str:
    """'ok' if `target` has the digest and size the manifest pinned, 'pinned'
    if the manifest had none (it is recorded now); RuntimeError with both
    digests on any difference."""
    dest = Path(dest)
    manifest = load_manifest(dest)
    digest = file_sha256(target)
    size = target.stat().st_size
    entry = manifest.get(name)
    if entry is not None:
        if entry["sha256"] != digest or entry["size"] != size:
            raise RuntimeError(
                f"[{name}] checkpoint integrity FAILURE: {target} has sha256={digest} size={size}, "
                f"manifest pinned sha256={entry['sha256']} size={entry['size']}: the file changed since it "
                f"was verified; delete it (and the manifest entry) only if the change is intentional"
            )
        return "ok"
    manifest[name] = {"filename": target.name, "sha256": digest, "size": size}
    dest.mkdir(parents=True, exist_ok=True)
    with open(dest / MANIFEST_NAME, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    return "pinned"


def _golden_dir() -> Path:
    return Path(__file__).resolve().parents[2] / "tests" / "golden"


def check_state_shapes(name: str, sd: dict) -> int:
    """The checkpoint's tensor keys and shapes against the reference golden's
    `sd::` entries: the number of tensors checked (0 where no golden covers
    `name`); RuntimeError listing every missing key and shape mismatch."""
    golden_path = _golden_dir() / f"{name}_reference_golden.npz"
    if not golden_path.exists():
        return 0
    wrap = _SD_UNWRAP.get(name)
    if wrap is not None and wrap in sd:
        sd = sd[wrap]
    golden = np.load(golden_path, allow_pickle=True)
    problems = []
    checked = 0
    for key in golden.files:
        if not key.startswith("sd::"):
            continue
        k = key[4:]
        want = tuple(golden[key].shape)
        if k not in sd:
            problems.append(f"missing tensor {k} (expected shape {want})")
            continue
        got = tuple(getattr(sd[k], "shape", ()))
        if got != want:
            problems.append(f"{k}: shape {got}, expected {want}")
        checked += 1
    if problems:
        raise RuntimeError(
            f"[{name}] checkpoint structure FAILURE vs reference golden ({len(problems)} problem(s)):\n  "
            + "\n  ".join(problems[:20])
        )
    return checked


def export_env(dest: Path) -> None:
    """Print (and set) the variables that point the loaders at the files
    present; name the missing ones."""
    for name, (filename, _, env) in CHECKPOINTS.items():
        target = Path(dest) / filename
        if target.exists():
            os.environ[env] = str(target)
            print(f"export {env}={target}")
        else:
            print(f"# missing: {name} -> {target}")


def _converters():
    """name -> a function that builds the port's network (on the CPU) from
    the checkpoint's raw dict."""
    from vfmreg_tpu_torch.models.dip import load_dip_state_dict
    from vfmreg_tpu_torch.models.gedi import load_gedi_state_dict
    from vfmreg_tpu_torch.models.pointdsc import load_pointdsc_state_dict
    from vfmreg_tpu_torch.models.sparse_resunet import FCGF_CONFIG, GCL_CONFIG, load_me_state_dict
    from vfmreg_tpu_torch.models.spinnet import load_spinnet_state_dict
    from vfmreg_tpu_torch.models.vit import PRESETS, ViT, load_dinov2_state_dict

    def dinov2(sd):
        cfg = PRESETS["dinov2_vits14"]
        return ViT(cfg).load_state_dict(load_dinov2_state_dict(sd, cfg))

    return {
        "fcgf": lambda sd: load_me_state_dict(sd.get("state_dict", sd), FCGF_CONFIG, device="cpu"),
        "gcl": lambda sd: load_me_state_dict(sd.get("state_dict", sd), GCL_CONFIG, device="cpu"),
        "dip": lambda sd: load_dip_state_dict(sd, device="cpu"),
        "gedi": lambda sd: load_gedi_state_dict(sd.get("pnet_model_state_dict", sd), device="cpu"),
        "spinnet": lambda sd: load_spinnet_state_dict(sd, device="cpu"),
        "pointdsc": lambda sd: load_pointdsc_state_dict(sd, device="cpu"),
        "dinov2": dinov2,
    }


def verify_loadable(dest: Path) -> None:
    """Pin (or check) every present file's digest, then load each
    checkpoint through its port loader after checking its tensor shapes
    against the golden."""
    import torch

    converters = _converters()
    for name, (filename, _, _) in CHECKPOINTS.items():
        target = Path(dest) / filename
        if not target.exists():
            continue
        pin = check_and_pin_manifest(dest, name, target)
        if name not in converters:
            # The CLIP merge table (gzip) and the jit-archived ViT-B-16.pt.
            print(f"[{name}] present, sha256 {pin} (no converter check)")
            continue
        sd = torch.load(target, map_location="cpu")
        n_shapes = check_state_shapes(name, sd)
        converters[name](sd)
        suffix = f", {n_shapes} tensor shapes vs golden" if n_shapes else ""
        print(f"[{name}] converted OK (sha256 {pin}{suffix})")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dest", type=str, default=None)
    parser.add_argument("--verify", action="store_true")
    args = parser.parse_args(argv)
    dest = Path(args.dest) if args.dest else cache_dir()
    export_env(dest)
    if args.verify:
        verify_loadable(dest)


if __name__ == "__main__":
    main()
