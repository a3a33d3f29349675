"""The 3xTF32 arithmetic of kernels B1 and B5, emulated in numpy.

`csrc/cosine_argmax.cu` (B1) and `csrc/flash_attention.cu` (B5) run their
inner products on the tensor cores as three TF32 products: each operand x
is split into big(x) = cvt.rna.tf32.f32(x) and small(x) =
cvt.rna.tf32.f32(x - big(x)), and a.b is summed in f32 as small(a).big(b)
+ big(a).small(b) + big(a).big(b). This file emulates that split on the
CPU (no GPU needed) and holds it to the gates the kernels are held to on
the card:

* similarity (B1) at its value range, unit-norm 384-d rows: within
  SIM_ATOL of float64, and the arg-max equal wherever the float64 top-2
  gap exceeds GAP (`chip_smoke.py`, `tests/test_torch_matching.py`);
* attention (B5) at the [1, 321, 6, 64] q, k, v of
  `tests/test_torch_attention.py` and at the reference test's
  [2, 200, 4, 32]: within ATTN_ATOL of `reference_attention`;
* one TF32 pass alone: its largest similarity error is at least ten times
  the 3xTF32 error on the same inputs, and above SIM_ATOL, which is why the
  kernels take three products.

cvt.rna rounds to nearest with ties away from zero: on the bits of |x|,
add 0x1000 and clear the low 13 bits. Products of two TF32 values are exact
in f32, so a float32 matmul of the parts sums them as the tensor core's f32
accumulator does, up to the order of the sum.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from vfmreg_tpu.ops import flash_attention as jfa  # noqa: E402
from vfmreg_tpu_torch.ops.flash_attention import flash_attention_plain  # noqa: E402

SIM_ATOL = 1e-5
GAP = 1e-5
ATTN_ATOL = 2e-5


def tf32_rna(x):
    """cvt.rna.tf32.f32: keep 10 mantissa bits, round half away from zero."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    sign = u & np.uint32(0x80000000)
    mag = ((u & np.uint32(0x7FFFFFFF)) + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    return (sign | mag).view(np.float32)


def split(x):
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def matmul_3xtf32(a, b):
    """a @ b in 3xTF32: the small terms first, each product summed in f32."""
    ab, as_ = split(a)
    bb, bs = split(b)
    return (as_ @ bb) + (ab @ bs) + (ab @ bb)


def _unit(rng, shape):
    x = rng.normal(size=shape)
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _qkv(shape, seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return [(rng.normal(size=shape) * s).astype(np.float32) for s in (scale, scale, 1.0)]


def _sim_inputs(seed):
    rng = np.random.RandomState(seed)
    return _unit(rng, (256, 384)), _unit(rng, (4096, 384))


def attention_3xtf32(q, k, v):
    """Softmax attention [B, T, H, hd] with both products in 3xTF32 and the
    softmax in f32; q is scaled by 1/sqrt(hd) in f32 first, as B5 does."""
    hd = q.shape[-1]
    qs = q * np.float32(1.0 / np.sqrt(hd))
    qh, kh, vh = (np.ascontiguousarray(x.transpose(0, 2, 1, 3)) for x in (qs, k, v))
    s = matmul_3xtf32(qh, kh.transpose(0, 1, 3, 2))
    p = np.exp(s - s.max(axis=-1, keepdims=True))
    o = matmul_3xtf32(p, vh) / p.sum(axis=-1, keepdims=True)
    return o.transpose(0, 2, 1, 3)


@pytest.mark.parametrize("x,want", [
    (1.0 + 2.0**-11, 1.0 + 2.0**-10),   # a tie rounds away from zero
    (-(1.0 + 2.0**-11), -(1.0 + 2.0**-10)),
    (1.0 + 2.0**-11 - 2.0**-23, 1.0),   # below the tie rounds down
    (1.0 + 3 * 2.0**-11, 1.0 + 2 * 2.0**-10),
    (0.0, 0.0),
])
def test_tf32_rna_rounding(x, want):
    assert tf32_rna(np.float32(x)).item() == want
    # small rounds the residual again, so big + small keeps ~21 bits of x.
    big, small = (a.item() for a in split(np.float32(x)))
    assert abs(big + small - x) <= 2.0**-22 * abs(x)


@pytest.mark.parametrize("seed", [0, 1])
def test_3xtf32_similarity_within_gate(seed):
    q, db = _sim_inputs(seed)
    sim = matmul_3xtf32(q, db.T)
    ref = q.astype(np.float64) @ db.astype(np.float64).T
    assert np.abs(sim - ref).max() <= SIM_ATOL
    top2 = np.sort(ref, axis=1)[:, -2:]
    decisive = (top2[:, 1] - top2[:, 0]) > GAP
    assert decisive.mean() > 0.9
    np.testing.assert_array_equal(sim.argmax(axis=1)[decisive], ref.argmax(axis=1)[decisive])


@pytest.mark.parametrize("shape,scale", [((1, 321, 6, 64), 0.5), ((2, 200, 4, 32), 1.0)])
def test_3xtf32_attention_within_gate(shape, scale):
    q, k, v = _qkv(shape, seed=shape[1], scale=scale)
    got = attention_3xtf32(q, k, v)
    ref = np.asarray(jfa.reference_attention(*(jnp.asarray(a) for a in (q, k, v))))
    np.testing.assert_allclose(got, ref, atol=ATTN_ATOL, rtol=0)
    plain = flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v))).numpy()
    np.testing.assert_allclose(got, plain, atol=ATTN_ATOL, rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_single_tf32_pass_misses_the_gate(seed):
    q, db = _sim_inputs(seed)
    ref = q.astype(np.float64) @ db.astype(np.float64).T
    err3 = np.abs(matmul_3xtf32(q, db.T) - ref).max()
    err1 = np.abs(tf32_rna(q) @ tf32_rna(db).T - ref).max()
    print(f"max |sim - f64|: one TF32 pass {err1:.3e}, 3xTF32 {err3:.3e}, SIM_ATOL {SIM_ATOL:.0e}")
    assert err1 >= 10 * err3
    assert err1 > SIM_ATOL
