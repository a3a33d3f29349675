"""Parity of the port's trainer (`vfmreg_tpu_torch.train`) with `vfmreg_tpu.train`.

Sizes are the reference test's (`tests/test_trainer.py`): the TINY ViT (64
wide, 2 layers, 4 heads, patch 14, 4 x 4 position grid, no flash),
`TrainConfig(adapter_hidden=64, adapter_out=32)`, a batch of 4 pairs of
56 x 56 images (view b = view a + 0.05 noise) with K = 8 corresponding
patches. The JAX side runs `create_train_state` / `make_train_step` on a
1 x 1 `("data", "model")` mesh; its parameters (and, after steps, adam's
moments and count) go through `convert.train_state_from_numpy` into the
port's state, so both sides compute from the same numbers.

* Loss, accuracy and every gradient leaf against `jax.value_and_grad` of
  the reference's objective (built here from `vit_forward` and
  `_adapter_forward`: the reference's `loss_fn` is a closure): the loss
  within a relative LOSS_RTOL, the accuracy equal, each leaf within
  GRAD_RTOL of its largest magnitude (f32 sums in other orders through
  two blocks, the 1/T = 14.3 logit scale and both softmaxes; 2.5e-6
  measured), the k biases' (exactly zero) within ZERO_GRAD_RTOL of the
  largest gradient.
* AdamW alone: one update from a state carried across after 2 JAX steps,
  fed the same gradients as optax's `adamw` (algebraically equal updates):
  both moments within ADAM_RTOL of each leaf's largest entry (1.2e-7
  measured), and each parameter within 2 ulp of optax's plus UPDATE_RTOL
  of its update (optax's update on the CPU reads 4e-6 off its float64
  value where the port's is within an ulp; 0.6 of the bound measured).
* Three whole steps against `make_train_step`: losses within LOSS_RTOL,
  accuracies equal, parameters within STEP_ATOL, and the k biases within
  3 x SIGN_ATOL (Adam follows the sign of their noise gradient).
* The loss descends over 5 steps on a fixed batch (the reference test's
  check), checkpoint round trip, `latest_checkpoint`, and a resumed run's
  next step equal bit for bit to the uninterrupted one.
* A (1, 1) mesh in this process (gloo, one rank) against `mesh=None`: the
  step's loss, gradients and parameters bit for bit.

Torch work runs on one intra-op thread. The world-4 splits are in
`tests/test_torch_trainer_mesh.py`.
"""

import dataclasses
import datetime

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from vfmreg_tpu.models import vit as jvit  # noqa: E402
from vfmreg_tpu.train import trainer as jtrain  # noqa: E402
from vfmreg_tpu_torch import convert  # noqa: E402
from vfmreg_tpu_torch.models import vit as tvit  # noqa: E402
from vfmreg_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from vfmreg_tpu_torch.train import trainer as ttrain  # noqa: E402

TINY = jvit.ViTConfig(hidden_size=64, num_layers=2, num_heads=4, patch_size=14, pretrain_img_size=56,
                      use_flash_attention=False)
PORT_TINY = tvit.ViTConfig(hidden_size=64, num_layers=2, num_heads=4, patch_size=14, pretrain_img_size=56,
                           use_flash_attention=False)
JCFG = jtrain.TrainConfig(adapter_hidden=64, adapter_out=32)
TCFG = ttrain.TrainConfig(adapter_hidden=64, adapter_out=32)
LOSS_RTOL, GRAD_RTOL, ADAM_RTOL, UPDATE_RTOL = 1e-5, 2e-5, 1e-6, 1e-5
# The k biases' exact gradient is zero (a constant added to every key shifts
# each query's logits by a constant, which the softmax ignores): on both
# sides it is rounding noise, held below ZERO_GRAD_RTOL of the largest
# gradient entry of the model.
ZERO_GRAD_RTOL = 1e-6
# Three whole steps: each parameter within STEP_ATOL (8.1e-7 measured), the
# k biases within SIGN_ATOL a step (their gradient is rounding noise, see
# ZERO_GRAD_RTOL, so Adam's first updates lr x g / (|g| + eps) take the
# noise's sign: up to 2 x lr a step apart; 2.0e-5 measured after 3).
STEP_ATOL, SIGN_ATOL = 5e-6, 2 * JCFG.learning_rate


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed=42, b=4, hw=56, k=8, grid=16):
    """tests/test_trainer.py's `_batch`, from its own seed."""
    rng = np.random.RandomState(seed)
    ia = rng.normal(size=(b, hw, hw, 3)).astype(np.float32)
    ib = ia + 0.05 * rng.normal(size=ia.shape).astype(np.float32)
    idx = rng.randint(0, grid, (b, k)).astype(np.int32)
    return ia, ib, idx


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x), tree)


@pytest.fixture(scope="module")
def jax_mesh():
    return Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _jax_objective(params, ia, ib, idx):
    """The reference's `loss_fn` (`vfmreg_tpu/train/trainer.py:141-158`)."""
    feats_a = jvit.vit_forward(params["vit"], ia, TINY)["patches"]
    feats_b = jvit.vit_forward(params["vit"], ib, TINY)["patches"]
    b, gh, gw, d = feats_a.shape
    fa, fb = feats_a.reshape(b, gh * gw, d), feats_b.reshape(b, gh * gw, d)
    za = jtrain._adapter_forward(params["adapter"], jnp.take_along_axis(fa, idx[..., None], 1))
    zb = jtrain._adapter_forward(params["adapter"], jnp.take_along_axis(fb, idx[..., None], 1))
    za, zb = za.reshape(-1, za.shape[-1]), zb.reshape(-1, zb.shape[-1])
    logits = za @ zb.T / JCFG.temperature
    labels = jnp.arange(za.shape[0])
    loss = 0.5 * (optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()
                  + optax.softmax_cross_entropy_with_integer_labels(logits.T, labels).mean())
    return loss, jnp.mean(jnp.argmax(logits, axis=1) == labels)


def _port_state(seed=0):
    state, _, _ = ttrain.create_train_state(torch.Generator().manual_seed(seed), PORT_TINY, None, TCFG, "cpu")
    return state


def _jax_state(mesh):
    with mesh:
        state, _, tx = jtrain.create_train_state(jax.random.PRNGKey(0), TINY, mesh, JCFG)
    return state, tx


def _carry(jstate):
    """The port's state from a JAX `TrainState` (numpy copies first: the JAX
    step donates its state)."""
    adam = jstate.opt_state[0]
    params = _np(jstate.params)
    count = int(np.asarray(adam.count))
    if count == 0:
        return convert.train_state_from_numpy(_port_state(1), params, PORT_TINY, step=int(jstate.step))
    return convert.train_state_from_numpy(_port_state(1), params, PORT_TINY, _np(adam.mu), _np(adam.nu), count,
                                          step=int(jstate.step))


def _params(state):
    return {n: p.detach().clone() for n, p in state.model.named_parameters()}


def _f64(x):
    return (x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)).astype(np.float64)


def _assert_close_leaves(got, want, rtol, what, zero=()):
    """Each leaf within rtol of its own largest magnitude; the `zero` leaves
    (exactly zero in exact arithmetic) within ZERO_GRAD_RTOL of the largest
    entry of all leaves, on both sides."""
    assert set(got) == set(want), what
    top = max(float(np.abs(_f64(w)).max()) for w in want.values())
    for name in want:
        g, w = _f64(got[name]), _f64(want[name])
        assert g.shape == w.shape, (what, name)
        if name in zero:
            assert max(np.abs(g).max(), np.abs(w).max()) <= ZERO_GRAD_RTOL * top, (what, name)
            continue
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= rtol * scale, f"{what} {name}: max err {err:.3e} > {rtol} x {scale:.3e}"


def test_config_and_optimizer_match_reference():
    assert dataclasses.asdict(ttrain.TrainConfig()) == dataclasses.asdict(jtrain.TrainConfig())
    state = _port_state()
    group = state.optimizer.param_groups[0]
    assert (group["lr"], group["weight_decay"], group["betas"], group["eps"]) == (1e-4, 0.05, (0.9, 0.999), 1e-8)
    assert len(group["params"]) == len(list(state.model.parameters()))


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.create_train_state(torch.Generator().manual_seed(0), PORT_TINY, None, TCFG)


def test_init_scales_and_spec():
    state, spec, opt = ttrain.create_train_state(torch.Generator().manual_seed(0), PORT_TINY, None, TCFG, "cpu")
    assert opt is state.optimizer and state.step == 0
    a = state.model.adapter
    assert a.fc1.weight.shape == (64, 64) and a.fc2.weight.shape == (32, 64)
    assert abs(float(a.fc1.weight.detach().std()) - (2 / 64) ** 0.5) < 0.02
    assert not a.fc1.bias.detach().any() and not a.fc2.bias.detach().any()
    assert spec["vit.blocks.0.attn.q.weight"] == ("model", None)
    assert spec["vit.blocks.0.attn.proj.weight"] == (None, "model")
    assert spec["vit.blocks.1.fc2.bias"] == () and spec["adapter.fc1.bias"] == ("model",)
    assert spec["vit.pos_embed"] == () and set(spec) == {n for n, _ in state.model.named_parameters()}
    # The gathered parameters load into the descriptor pass's plain ViT.
    full = ttrain.full_state(state)["params"]
    vit = tvit.ViT(PORT_TINY)
    vit.load_state_dict({k[4:]: v for k, v in full.items() if k.startswith("vit.")})


def test_loss_and_gradients_match_jax(jax_mesh):
    jstate, _ = _jax_state(jax_mesh)
    ia, ib, idx = _batch()
    (loss, acc), grads = jax.value_and_grad(_jax_objective, has_aux=True)(
        jstate.params, jnp.asarray(ia), jnp.asarray(ib), jnp.asarray(idx))
    state = _carry(jstate)
    m = state.model
    pa, pb = m.vit(torch.from_numpy(np.concatenate([ia, ib])))["patches"].chunk(2)
    tloss, tacc = ttrain.info_nce_loss(m.adapter, pa, pb, torch.from_numpy(idx), TCFG.temperature)
    tloss.backward()
    assert abs(float(tloss.detach()) - float(loss)) <= LOSS_RTOL * abs(float(loss))
    assert float(tacc) == float(acc)
    want = convert.train_params_from_numpy(_np(grads), PORT_TINY)
    zero = [n for n in want if n.endswith("attn.k.bias")]
    _assert_close_leaves({n: p.grad for n, p in m.named_parameters()}, want, GRAD_RTOL, "grad", zero)


def test_adamw_update_matches_optax(jax_mesh):
    jstate, tx = _jax_state(jax_mesh)
    step = jtrain.make_train_step(TINY, jax_mesh, JCFG, tx)
    ia, ib, idx = (jnp.asarray(x) for x in _batch())
    with jax_mesh:
        for _ in range(2):
            jstate, _ = step(jstate, ia, ib, idx)
    (_, _), grads = jax.value_and_grad(_jax_objective, has_aux=True)(jstate.params, ia, ib, idx)
    state = _carry(jstate)
    assert float(state.optimizer.state[state.model.vit.pos_embed]["step"]) == 2.0
    updates, opt_state = tx.update(grads, jstate.opt_state, jstate.params)
    new_params = optax.apply_updates(jstate.params, updates)
    for name, g in convert.train_params_from_numpy(_np(grads), PORT_TINY).items():
        state.model.get_parameter(name).grad = g.clone()
    state.optimizer.step()
    named = dict(state.model.named_parameters())
    before = convert.train_params_from_numpy(_np(jstate.params), PORT_TINY)
    for name, want in convert.train_params_from_numpy(_np(new_params), PORT_TINY).items():
        got, want, old = _f64(named[name]), _f64(want), _f64(before[name])
        bound = 2 * np.spacing(np.abs(want).astype(np.float32)) + UPDATE_RTOL * np.abs(want - old)
        assert np.all(np.abs(got - want) <= bound), name
    for key, tree in (("exp_avg", opt_state[0].mu), ("exp_avg_sq", opt_state[0].nu)):
        got = {n: state.optimizer.state[p][key] for n, p in named.items()}
        _assert_close_leaves(got, convert.train_params_from_numpy(_np(tree), PORT_TINY), ADAM_RTOL, key)


def test_three_steps_match_jax(jax_mesh):
    jstate, tx = _jax_state(jax_mesh)
    state = _carry(jstate)
    jstep = jtrain.make_train_step(TINY, jax_mesh, JCFG, tx)
    tstep = ttrain.make_train_step(PORT_TINY, None, TCFG)
    ia, ib, idx = _batch()
    for _ in range(3):
        with jax_mesh:
            jstate, jm = jstep(jstate, jnp.asarray(ia), jnp.asarray(ib), jnp.asarray(idx))
        state, tm = tstep(state, ia, ib, idx)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_RTOL * abs(float(jm["loss"]))
        assert float(tm["accuracy"]) == float(jm["accuracy"])
    assert state.step == int(jstate.step) == 3
    want = convert.train_params_from_numpy(_np(jstate.params), PORT_TINY)
    for name, p in state.model.named_parameters():
        err = float((p.detach() - want[name]).abs().max())
        assert err <= (3 * SIGN_ATOL if name.endswith("attn.k.bias") else STEP_ATOL), f"{name}: {err}"


def test_loss_descends():
    state = _port_state()
    step = ttrain.make_train_step(PORT_TINY, None, TCFG)
    ia, ib, idx = _batch()
    losses = []
    for _ in range(5):
        state, m = step(state, ia, ib, idx)
        losses.append(float(m["loss"]))
    assert np.all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert state.step == 5


def test_checkpoint_roundtrip_and_resume(tmp_path):
    step = ttrain.make_train_step(PORT_TINY, None, TCFG)
    ia, ib, idx = _batch()
    state = _port_state()
    assert ttrain.latest_checkpoint(tmp_path) is None
    for _ in range(2):
        state, _ = step(state, ia, ib, idx)
    path = ttrain.save_checkpoint(tmp_path, state)
    assert path.endswith("step_00000002") and ttrain.latest_checkpoint(tmp_path) == path
    ttrain.save_checkpoint(tmp_path, state, step=1)
    assert ttrain.latest_checkpoint(tmp_path) == path

    fresh = ttrain.restore_checkpoint(path, _port_state(seed=7))
    assert fresh.step == 2
    for (name, a), b in zip(state.model.named_parameters(), fresh.model.parameters()):
        assert torch.equal(a, b), name
    state, m1 = step(state, ia, ib, idx)
    fresh, m2 = step(fresh, ia, ib, idx)
    assert torch.equal(m1["loss"], m2["loss"]) and fresh.step == state.step == 3
    for (name, a), b in zip(state.model.named_parameters(), fresh.model.parameters()):
        assert torch.equal(a, b), name
        assert torch.equal(state.optimizer.state[a]["exp_avg_sq"], fresh.optimizer.state[b]["exp_avg_sq"]), name


def test_checkpoint_before_first_step(tmp_path):
    state = _port_state()
    path = ttrain.save_checkpoint(tmp_path, state)
    fresh = ttrain.restore_checkpoint(path, _port_state(seed=3))
    assert fresh.step == 0 and not fresh.optimizer.state
    for a, b in zip(state.model.parameters(), fresh.model.parameters()):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A one-rank gloo group in this process and a (1, 1) ("data", "model") mesh."""
    assert not dist.is_initialized()
    d = tmp_path_factory.mktemp("world1")
    dist.init_process_group("gloo", init_method=f"file://{d}/store", world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield make_mesh(("data", "model"), (1, 1))
    finally:
        dist.destroy_process_group()


def test_world1_mesh_step_equals_single(world1, tmp_path):
    ia, ib, idx = _batch()
    runs = {}
    for name, mesh in (("single", None), ("mesh", world1)):
        state, _, _ = ttrain.create_train_state(torch.Generator().manual_seed(0), PORT_TINY, mesh, TCFG, "cpu")
        state, m = ttrain.make_train_step(PORT_TINY, mesh, TCFG)(state, ia, ib, idx)
        grads = {n: p.grad.clone() for n, p in state.model.named_parameters()}
        runs[name] = (m, grads, _params(state), state)
    (m0, g0, p0, _), (m1, g1, p1, mstate) = runs["single"], runs["mesh"]
    assert torch.equal(m0["loss"], m1["loss"]) and torch.equal(m0["accuracy"], m1["accuracy"])
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
        assert torch.equal(p0[name], p1[name]), name
    # A checkpoint of the split state restores into a single-device one.
    path = ttrain.save_checkpoint(tmp_path, mstate)
    single = ttrain.restore_checkpoint(path, _port_state(seed=5))
    for name, p in single.model.named_parameters():
        assert torch.equal(p, p1[name]), name


@pytest.mark.parametrize("change", [{"ffn": "swiglu"}, {"num_register_tokens": 4},
                                    {"ffn": "swiglu", "num_register_tokens": 4, "interpolate_antialias": True}])
def test_split_refuses_swiglu_and_registers(change):
    """The tp split knows the GELU MLP's fc1 / fc2 only: a SwiGLU or register
    config (dinov2_vitg14_reg's kind) is refused, not sharded wrongly."""
    cfg = dataclasses.replace(PORT_TINY, **change)
    with pytest.raises(NotImplementedError, match="register tokens"):
        ttrain.create_train_state(torch.Generator().manual_seed(0), cfg, None, TCFG, "cpu")
    vit = tvit.init_vit(cfg, torch.Generator().manual_seed(0), device="cpu")
    adapter = ttrain.init_adapter(torch.Generator().manual_seed(1), cfg.hidden_size, TCFG, device="cpu")
    with pytest.raises(NotImplementedError, match="would shard wrongly"):
        ttrain.shard_vit_params(vit, adapter)
