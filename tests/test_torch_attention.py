"""Parity of the port's attention (kernel B5's wrapper) with `vfmreg_tpu`.

On CPU tensors `vfmreg_tpu_torch.ops.flash_attention.flash_attention` runs
its plain version (the einsum softmax). It is held against the Pallas
`flash_attention` in interpret mode and against `reference_attention`, on
inputs made with numpy from a seed:

* [2, 200, 4, 32] unit normals, the reference test's shape
  (`tests/test_vit.py::test_flash_attention_matches_reference`);
* [1, 321, 6, 64], the ViT-S/14 descriptor pass's shape (16 x 20 patches
  and the cls token; T = 321 is padded to the Pallas blocks), with q and k
  scaled as the ViT's LayerNorm'd projections are.

Tolerance: atol 2e-5, the reference test's bar (the online softmax and the
einsum sum in different orders).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from vfmreg_tpu.ops import flash_attention as jfa  # noqa: E402
from vfmreg_tpu_torch.ops import flash_attention as tfa  # noqa: E402

ATOL = 2e-5


def _qkv(shape, seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return [(rng.normal(size=shape) * s).astype(np.float32) for s in (scale, scale, 1.0)]


@pytest.mark.parametrize("shape,block,scale", [
    ((2, 200, 4, 32), 64, 1.0),
    ((1, 321, 6, 64), 128, 0.5),
])
def test_attention_matches_pallas_and_reference(shape, block, scale):
    q, k, v = _qkv(shape, seed=shape[1], scale=scale)
    got = tfa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v))).numpy()
    assert got.shape == shape and np.isfinite(got).all()
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    pallas = np.asarray(jfa.flash_attention(jq, jk, jv, block_q=block, block_k=block, interpret=True))
    ref = np.asarray(jfa.reference_attention(jq, jk, jv))
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_attention_wrapper_checks_inputs():
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 5, 2, 8), seed=0))
    with pytest.raises(TypeError):
        tfa.flash_attention(q.double(), k, v)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, k[:, :4], v)
    with pytest.raises(ValueError):
        tfa.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
