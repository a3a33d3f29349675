"""Baseline point-descriptor extractors: the reference's `descriptors.py` surface.

Counterpart of `vfmreg_tpu/descriptors/__init__.py`. Each extractor has
the signature `extract_<name>_features(pcl, ...) -> (points, features)`,
numpy in and out, and runs on `device` (default: the card). The learned
ones read their weights from `VFMREG_{DIP,GEDI,SPINNET,FCGF,GCL}_WEIGHTS` (a
torch state dict in the reference checkpoint's layout; FCGF's and GCL's may
be the MinkowskiEngine checkpoint dict holding it under 'state_dict') and
use seeded random weights without them, as the reference does.
"""

from vfmreg_tpu_torch.descriptors.fpfh import extract_fpfh_features  # noqa: F401


def get_extractor(name: str):
    """The registry of the scene loop: fpfh, dip, gedi, fcgf, gcl, spinnet.
    KeyError for any other name, as the reference's registry."""
    from vfmreg_tpu_torch.descriptors import dip, fcgf, fpfh, gcl, gedi, spinnet

    registry = {
        "fpfh": fpfh.extract_fpfh_features,
        "dip": dip.extract_dip_features,
        "gedi": gedi.extract_gedi_features,
        "fcgf": fcgf.extract_fcgf_features,
        "gcl": gcl.extract_gcl_features,
        "spinnet": spinnet.extract_spinnet_features,
    }
    return registry[name]
