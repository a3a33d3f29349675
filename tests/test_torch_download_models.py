"""The port's checkpoint conversion (`pipeline/download_models.py`) against `vfmreg_tpu`'s.

On synthetic checkpoints made from the reference goldens' state dicts
(`tests/golden/*_reference_golden.npz`, `sd::` entries), nested as the
published files are (FCGF and GCL under 'state_dict', GeDi under
'pnet_model_state_dict'):

* the table of checkpoints (files, sources, variables) is the reference's;
* `check_state_shapes` counts the same tensors as the reference's for each
  of the six, and both name a missing tensor and a wrong shape;
* `verify_loadable` pins each file on first sight with the same manifest
  the reference writes, loads it through the port's loaders, passes on the
  second run, and fails on a changed file;
* `export_env` prints the reference's lines and sets the variables; the CLI
  (convert-only) names the missing files.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vfmreg_tpu.pipeline import download_models as jdm  # noqa: E402
from vfmreg_tpu_torch.pipeline import download_models as tdm  # noqa: E402

GOLDEN = Path(__file__).resolve().parent / "golden"
WRAP = {"fcgf": "state_dict", "gcl": "state_dict", "gedi": "pnet_model_state_dict"}
NAMES = ("fcgf", "gcl", "dip", "gedi", "spinnet", "pointdsc")


def _state_dict(name):
    g = np.load(GOLDEN / f"{name}_reference_golden.npz")
    return {k[4:]: torch.from_numpy(np.array(g[k])) for k in g.files if k.startswith("sd::")}


def _checkpoint(name):
    sd = _state_dict(name)
    return {WRAP[name]: sd, "epoch": 7} if name in WRAP else sd


def test_table_is_the_reference():
    assert tdm.CHECKPOINTS == jdm.CHECKPOINTS
    assert tdm.MANIFEST_NAME == jdm.MANIFEST_NAME


@pytest.mark.parametrize("name", NAMES)
def test_check_state_shapes_matches_reference(name):
    ckpt = _checkpoint(name)
    n = tdm.check_state_shapes(name, ckpt)
    assert n == jdm.check_state_shapes(name, ckpt) > 5
    sd = dict(_state_dict(name))
    first = sorted(sd)[0]
    del sd[first]
    second = sorted(sd)[-1]
    sd[second] = torch.zeros(3, 1, 2)
    for mod in (tdm, jdm):
        with pytest.raises(RuntimeError, match="structure FAILURE") as e:
            mod.check_state_shapes(name, sd)
        assert f"missing tensor {first}" in str(e.value) and f"{second}: shape (3, 1, 2)" in str(e.value)
    assert tdm.check_state_shapes("dinov2", {}) == 0  # no golden covers it


@pytest.fixture
def dest(tmp_path):
    for name in NAMES:
        torch.save(_checkpoint(name), tmp_path / tdm.CHECKPOINTS[name][0])
    (tmp_path / tdm.CHECKPOINTS["clip_bpe"][0]).write_bytes(b"not a torch file")
    return tmp_path


def test_verify_loadable_pins_converts_and_detects_changes(dest, tmp_path_factory, capsys):
    tdm.verify_loadable(dest)
    out = capsys.readouterr().out
    for name in NAMES:
        assert f"[{name}] converted OK (sha256 pinned, " in out, name
    assert "[clip_bpe] present, sha256 pinned (no converter check)" in out
    manifest = json.loads((dest / tdm.MANIFEST_NAME).read_text())
    # The reference pins the same files to the same manifest.
    other = tmp_path_factory.mktemp("jax_manifest")
    for name, (filename, _, _) in jdm.CHECKPOINTS.items():
        if (dest / filename).exists():
            jdm.check_and_pin_manifest(other, name, dest / filename)
    assert json.loads((other / jdm.MANIFEST_NAME).read_text()) == manifest
    assert set(manifest) == set(NAMES) | {"clip_bpe"}

    tdm.verify_loadable(dest)
    assert "converted OK (sha256 ok" in capsys.readouterr().out
    target = dest / tdm.CHECKPOINTS["gcl"][0]
    target.write_bytes(target.read_bytes() + b"\0")
    with pytest.raises(RuntimeError, match="integrity FAILURE"):
        tdm.verify_loadable(dest)


def test_export_env_and_cli(dest, monkeypatch, capsys):
    for _, _, env in tdm.CHECKPOINTS.values():
        monkeypatch.delenv(env, raising=False)
    jdm.export_env(dest)
    want = capsys.readouterr().out
    tdm.export_env(dest)
    assert capsys.readouterr().out == want
    assert tdm.CHECKPOINTS["fcgf"][2] in want and "# missing: dinov2" in want
    assert os.environ["VFMREG_GCL_WEIGHTS"] == str(dest / tdm.CHECKPOINTS["gcl"][0])
    tdm.main(["--dest", str(dest), "--verify"])
    out = capsys.readouterr().out
    assert "# missing: dinov2" in out and "[fcgf] converted OK" in out
    monkeypatch.setenv("VFMREG_CACHE", str(dest / "elsewhere"))
    assert tdm.cache_dir() == dest / "elsewhere"
