"""Baseline point-descriptor extractors: the reference's `descriptors.py` surface.

Counterpart of `vfmreg_tpu/descriptors/__init__.py`. Each extractor has
the signature `extract_<name>_features(pcl, ...) -> (points, features)`,
numpy in and out, and runs on `device` (default: the card). The learned
ones read their weights from `VFMREG_{DIP,GEDI,SPINNET}_WEIGHTS` (a torch
state dict in the reference checkpoint's layout) and use seeded random
weights without them, as the reference does.
"""

from vfmreg_tpu_torch.descriptors.fpfh import extract_fpfh_features  # noqa: F401

# Extractors of the reference that the port has not taken yet.
NOT_PORTED = {"fcgf": "A13b", "gcl": "A13b"}


def get_extractor(name: str):
    """The registry of the scene loop: fpfh, dip, gedi, spinnet. KeyError for
    any other name, as the reference's registry when an extractor's imports
    are missing; FCGF and GCL (the sparse-convolution stack) wait for
    ROADMAP A13b."""
    from vfmreg_tpu_torch.descriptors import dip, fpfh, gedi, spinnet

    registry = {
        "fpfh": fpfh.extract_fpfh_features,
        "dip": dip.extract_dip_features,
        "gedi": gedi.extract_gedi_features,
        "spinnet": spinnet.extract_spinnet_features,
    }
    if name in NOT_PORTED:
        raise KeyError(f"the {name} extractor is not ported yet (ROADMAP {NOT_PORTED[name]})")
    return registry[name]
