"""The port's trainer split dp x tp over 4 gloo ranks, against one process.

The ranks (`tests/torch_mesh_workers.trainer_checks`, spawned once) run
`train.trainer` on `("data", "model")` meshes of (2, 2), (1, 4) and (4, 1)
with the reference test's TINY ViT and batch (`tests/test_trainer.py`), and
(1, 4) once more with 2 heads, which do not divide by "model" (each rank
holds half a head: q, k and v are gathered over "model"). This process runs
the same steps with `mesh=None` from the same seed, on the same global
batch. Every rank must return the same gathered tensors; the tests read
rank 0's.

* The q weight's shard: 16 of 64 output rows at "model" = 4 (the
  reference test's split), 32 at 2, all 64 at 1.
* Step 1: loss within LOSS_RTOL, accuracy equal (the in-batch negatives
  span the global batch), every gathered gradient leaf within GRAD_RTOL of
  its own largest entry (the split sums partial products and the ranks'
  gradients in other orders), the k biases' (exactly zero) within
  ZERO_GRAD_RTOL of the largest gradient entry.
* Step 2: loss within LOSS_RTOL, gathered parameters within STEP_ATOL, but
  the entries whose step-1 gradient lies within the gradient tolerance
  (GRAD_RTOL of the leaf's largest; the k biases, whose exact gradient is
  zero, and the odd near-zero entry: 1 of the patch weight's 37,632 with 2
  heads at "model" = 4) within 2 x SIGN_ATOL: Adam's early updates
  lr x g / (|g| + eps) follow such a gradient's rounding sign, up to 2 x lr
  a step apart.
* A batch that does not divide by "data" raises.
* Checkpoints across splits: the (1, 4) state's checkpoint restores into a
  one-device state with the ranks' gathered parameters bit for bit; this
  process's checkpoint restores at (2, 2) with its parameters and moments
  bit for bit, and the next step's loss within LOSS_RTOL of this process's.

Each rank runs on one intra-op thread with a 60 s collective timeout.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests import torch_mesh_workers as W  # noqa: E402
from vfmreg_tpu_torch.train import trainer as T  # noqa: E402

# Measured: losses within 1.6e-6 (step 2 with split heads), gradient leaves
# within 1.0e-6 of their largest entry, parameters after step 2 within
# 1.4e-6 (an fc1 entry with split heads whose two small gradients nearly
# cancel in Adam's first moment) outside the noise entries.
LOSS_RTOL, GRAD_RTOL, ZERO_GRAD_RTOL = 1e-5, 1e-5, 1e-6
STEP_ATOL, SIGN_ATOL = 1e-5, 2e-4


def _single(heads, steps=2):
    """(metrics, gradients after step 1, state) of the one-process run."""
    cfg, tcfg = W.train_vit_config(heads), W.train_config()
    state, _, _ = T.create_train_state(torch.Generator().manual_seed(0), cfg, None, tcfg, "cpu")
    step = T.make_train_step(cfg, None, tcfg)
    ia, ib, idx = W.train_batch()
    metrics, grads = [], None
    for i in range(steps):
        state, m = step(state, ia, ib, idx)
        metrics.append((float(m["loss"]), float(m["accuracy"])))
        if i == 0:
            grads = {n: p.grad.numpy().copy() for n, p in state.model.named_parameters()}
    return metrics, grads, state


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tmp = tmp_path_factory.mktemp("trainer_world4")
        _, _, one_step = _single(4, steps=1)
        single_ckpt = T.save_checkpoint(tmp / "single", one_step)
        started = W.start(4, W.trainer_checks, tmp / "ranks", str(tmp / "ckpt"), single_ckpt)
        singles = {heads: _single(heads) for heads in sorted({h for _, h in W.TRAIN_CASES.values()})}
        res = started.results()
    finally:
        torch.set_num_threads(n)
    for r in res[1:]:
        for case in W.TRAIN_CASES:
            for key in ("grads", "params2"):
                for name, a in res[0][case][key].items():
                    np.testing.assert_array_equal(a, r[case][key][name], err_msg=f"{case} {key} {name}")
    return res[0], singles, one_step


def _assert_leaves(got, want, rtol, what):
    top = max(float(np.abs(w).max()) for w in want.values())
    assert set(got) == set(want), what
    for name, w in want.items():
        g = got[name].astype(np.float64)
        if name.endswith("attn.k.bias"):
            assert max(np.abs(g).max(), np.abs(w).max()) <= ZERO_GRAD_RTOL * top, (what, name)
            continue
        err, scale = float(np.abs(g - w).max()), float(np.abs(w).max())
        assert err <= rtol * scale, f"{what} {name}: {err:.3e} > {rtol} x {scale:.3e}"


@pytest.mark.parametrize("case", list(W.TRAIN_CASES))
def test_q_shard(ranks, case):
    (_, model), _ = W.TRAIN_CASES[case]
    assert ranks[0][case]["q_shard"] == (64 // model, 64)


@pytest.mark.parametrize("case", list(W.TRAIN_CASES))
def test_step1_equals_one_process(ranks, case):
    r, singles = ranks[0][case], ranks[1]
    (loss, acc), _ = singles[W.TRAIN_CASES[case][1]][0]
    assert abs(r["loss"] - loss) <= LOSS_RTOL * loss
    assert r["accuracy"] == acc
    _assert_leaves(r["grads"], singles[W.TRAIN_CASES[case][1]][1], GRAD_RTOL, f"{case} grad")


@pytest.mark.parametrize("case", list(W.TRAIN_CASES))
def test_step2_parameters(ranks, case):
    r, singles = ranks[0][case], ranks[1]
    metrics, grads, state = singles[W.TRAIN_CASES[case][1]]
    assert abs(r["loss2"] - metrics[1][0]) <= LOSS_RTOL * metrics[1][0]
    for name, p in state.model.named_parameters():
        err = np.abs(r["params2"][name] - p.detach().numpy())
        noise = (np.abs(grads[name]) <= GRAD_RTOL * np.abs(grads[name]).max()) | name.endswith("attn.k.bias")
        assert err[~noise].max(initial=0.0) <= STEP_ATOL, f"{case} {name}: {err[~noise].max()}"
        assert err[noise].max(initial=0.0) <= 2 * SIGN_ATOL, f"{case} {name}: {err[noise].max()}"


@pytest.mark.parametrize("case", [c for c, (shape, _) in W.TRAIN_CASES.items() if shape[0] > 1])
def test_batch_must_divide_data(ranks, case):
    assert "do not split" in ranks[0][case]["odd_batch"]


def test_split_checkpoint_restores_on_one_device(ranks):
    r = ranks[0]["tp4"]
    state, _, _ = T.create_train_state(torch.Generator().manual_seed(3), W.train_vit_config(), None,
                                       W.train_config(), "cpu")
    state = T.restore_checkpoint(r["ckpt"], state)
    assert state.step == 2
    for name, p in state.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), r["params2"][name], err_msg=name)


def test_one_device_checkpoint_restores_split(ranks):
    r, one_step = ranks[0]["restored"], ranks[2]
    full = T.full_state(one_step)
    assert r["step"] == 1
    for key in ("params", "exp_avg", "exp_avg_sq"):
        for name, t in full[key].items():
            np.testing.assert_array_equal(r[key][name], t.numpy(), err_msg=f"{key} {name}")
    loss2 = ranks[1][4][0][1][0]
    assert abs(r["loss_next"] - loss2) <= LOSS_RTOL * loss2
