"""Descriptor-refinement training: fine-tuning the DINOv2 ViT and an adapter.

Counterpart of `vfmreg_tpu/train/trainer.py`. The ViT (`models/vit.py`)
and a 2-layer projection adapter (fc1, tanh-approximated GELU, fc2, L2
normalisation) are trained with an in-batch InfoNCE over corresponding
patch descriptors of two views of the same scenes (`info_nce_loss`), with
AdamW at optax's `adamw` defaults (decay on every parameter).

Parallelism: dp x tp on a `("data", "model")` mesh
(`parallel.mesh.make_mesh`), one process per device, the collectives
explicit `torch.distributed` calls (`parallel.collectives`). The reference
lets GSPMD place them; here they are the Megatron pair:

* **tp** ("model"): q, k, v, the MLP's fc1 and the adapter's fc1 are
  column-parallel (each rank holds a block of their output rows); proj, the
  MLP's fc2 and the adapter's fc2 are row-parallel (a block of their input
  columns, the partial products summed by an all-reduce, the bias added
  once after it). `copy_to_model` (identity forward, all-reduce backward)
  stands before each column-parallel input and `reduce_from_model` (the
  converse) after each row-parallel product. Norms, the patch embedding,
  cls, the position embedding and LayerScale are replicated. Where the
  heads divide by the model axis, each rank attends over its own heads;
  where they do not (ViT-S's 6 heads at 4 ranks: 96 columns, 1.5 heads a
  rank), q, k and v are all-gathered over "model", every rank runs all
  heads, and keeps its own column block of the output for the row-parallel
  proj (the gather's backward sums the ranks' gradients and keeps the
  rank's block).
* **dp** ("data"): each rank takes its contiguous block of the batch (a
  batch that does not divide raises). The in-batch negatives span the
  global batch, as the reference's `[B*K, B*K]` logits do: the adapter's
  outputs are all-gathered over "data" in rank order, so every rank
  computes the same global loss; the gather's backward keeps the rank's own
  block, and the parameter gradients are summed over "data" (one all-reduce
  of all of them, flattened).

`mesh=None` is one device and the same code with no collective, so a
(1, 1) mesh gives the same step bit for bit. Kernel B5 has no backward
(the reference's Pallas kernel has no VJP either): with
`use_flash_attention` set, a step on the card raises, and the trainer runs
plain attention otherwise, as the reference's trainer runs XLA attention.

Checkpoints are `torch.save` files in the reference's `step_%08d`
directories: the full (gathered) parameters under the plain `ViT` /
adapter state-dict names, the AdamW moments and `step`, restored onto the
target's split, so a checkpoint written at one mesh shape loads at another.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from vfmreg_tpu_torch.models.vit import ViT, ViTConfig, init_vit
from vfmreg_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
from vfmreg_tpu_torch.parallel import collectives
from vfmreg_tpu_torch.parallel.mesh import shard_rows
from vfmreg_tpu_torch.utils.device import resolve_device
from vfmreg_tpu_torch.utils.profiling import span

SUM = dist.ReduceOp.SUM
# optax.adamw's defaults.
ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-8


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 0.05
    temperature: float = 0.07
    adapter_hidden: int = 512
    adapter_out: int = 128


@dataclasses.dataclass
class TrainState:
    model: "TrainModel"
    optimizer: torch.optim.Optimizer
    step: int = 0


# ---------------------------------------------------------------------------
# The Megatron f / g pair, and the gathers
# ---------------------------------------------------------------------------


class _CopyToModel(torch.autograd.Function):
    """f: identity forward, the gradient summed over "model" backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        return collectives.all_reduce(grad.clone(memory_format=torch.contiguous_format), SUM, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """g: the partial products summed over "model" forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return collectives.all_reduce(x.clone(memory_format=torch.contiguous_format), SUM, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherColumns(torch.autograd.Function):
    """Every model rank's column block, concatenated along the last axis;
    backward sums the ranks' gradients (each rank's attention output block
    depends on every column) and keeps this rank's block."""

    @staticmethod
    def forward(ctx, x, group, rank):
        ctx.group, ctx.rank, ctx.width = group, rank, x.shape[-1]
        return collectives.all_gather(x.contiguous(), group, dim=x.ndim - 1)

    @staticmethod
    def backward(ctx, grad):
        full = collectives.all_reduce(grad.clone(memory_format=torch.contiguous_format), SUM, ctx.group)
        return full.narrow(-1, ctx.rank * ctx.width, ctx.width).contiguous(), None, None


class _GatherData(torch.autograd.Function):
    """Every data rank's rows along `dim`, in rank order. The loss after it
    is the same on every data rank, so each rank's gradient of the gathered
    tensor is the whole one: backward keeps this rank's block."""

    @staticmethod
    def forward(ctx, x, group, rank, dim):
        ctx.rank, ctx.dim, ctx.n = rank, dim, x.shape[dim]
        return collectives.all_gather(x.contiguous(), group, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None, None


class _TakeRows(torch.autograd.Function):
    """`torch.gather` of x [B, N, D]'s rows idx [B, K] (the reference's
    `take_along_axis`), with a deterministic backward: the gradients of a
    row taken several times are summed by a one-hot product [B, N, K] x
    [B, K, D] in the product's fixed order, where `gather`'s backward
    (`scatter_add`) sums them by atomics in whatever order the card runs
    them. With TF32 off (`utils.precision.full_precision`) the product is
    exact: each term is a gradient times 1 or 0."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.rows = x.shape[1]
        return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        one_hot = F.one_hot(idx, ctx.rows).to(grad.dtype)
        return one_hot.transpose(1, 2) @ grad, None


def copy_to_model(x, group):
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x, group):
    return x if group is None else _ReduceFromModel.apply(x, group)


# ---------------------------------------------------------------------------
# Split modules
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """The "model" axis as a rank sees it; group None is one device."""

    group: object = None
    rank: int = 0
    world: int = 1


def _block(t: torch.Tensor, dim: int, axis: ModelAxis) -> torch.Tensor:
    n = t.shape[dim]
    if n % axis.world:
        raise ValueError(f"a dimension of {n} does not split over {axis.world} model ranks")
    k = n // axis.world
    return t.detach().narrow(dim, axis.rank * k, k).clone()


class ColumnParallelLinear(nn.Linear):
    """This rank's block of a Linear's output rows, after `copy_to_model`."""

    def __init__(self, full: nn.Linear, axis: ModelAxis, copy_input: bool = True):
        w = _block(full.weight, 0, axis)
        super().__init__(w.shape[1], w.shape[0], device=w.device)
        with torch.no_grad():
            self.weight.copy_(w)
            self.bias.copy_(_block(full.bias, 0, axis))
        self.axis, self.copy_input = axis, copy_input

    def forward(self, x):
        return super().forward(copy_to_model(x, self.axis.group) if self.copy_input else x)


class RowParallelLinear(nn.Linear):
    """This rank's block of a Linear's input columns: the partial products
    summed over "model", then the (replicated) bias."""

    def __init__(self, full: nn.Linear, axis: ModelAxis):
        w = _block(full.weight, 1, axis)
        super().__init__(w.shape[1], w.shape[0], device=w.device)
        with torch.no_grad():
            self.weight.copy_(w)
            self.bias.copy_(full.bias.detach())
        self.axis = axis

    def forward(self, x):
        return reduce_from_model(F.linear(x, self.weight), self.axis.group) + self.bias


class ParallelAttention(nn.Module):
    """`models.vit.Attention` with q, k, v column-parallel and proj
    row-parallel (same parameter names)."""

    def __init__(self, full, cfg: ViTConfig, axis: ModelAxis):
        super().__init__()
        self.q, self.k, self.v = (ColumnParallelLinear(lin, axis, copy_input=False)
                                  for lin in (full.q, full.k, full.v))
        self.proj = RowParallelLinear(full.proj, axis)
        self.num_heads, self.head_dim = cfg.num_heads, cfg.hidden_size // cfg.num_heads
        self.use_flash = cfg.use_flash_attention
        self.axis = axis
        self.local_heads = cfg.num_heads % axis.world == 0

    def forward(self, x):
        b, t, _ = x.shape
        attend = flash_attention if self.use_flash else flash_attention_plain
        x = copy_to_model(x, self.axis.group)
        qkv = [lin(x) for lin in (self.q, self.k, self.v)]
        if self.local_heads:
            out = attend(*(y.reshape(b, t, -1, self.head_dim) for y in qkv)).reshape(b, t, -1)
        else:
            full = _GatherColumns.apply(torch.stack(qkv), self.axis.group, self.axis.rank)
            out = attend(*(y.reshape(b, t, self.num_heads, self.head_dim) for y in full.unbind(0)))
            width = qkv[0].shape[-1]
            out = out.reshape(b, t, -1).narrow(-1, self.axis.rank * width, width)
        return self.proj(out)


class Adapter(nn.Module):
    """The projection head: fc1, GELU (tanh approximation, as `jax.nn.gelu`'s
    default), fc2, then an L2 normalisation by max(norm, 1e-8)."""

    def __init__(self, d_in: int, cfg: TrainConfig):
        super().__init__()
        self.fc1 = nn.Linear(d_in, cfg.adapter_hidden)
        self.fc2 = nn.Linear(cfg.adapter_hidden, cfg.adapter_out)

    def forward(self, x):
        out = self.fc2(F.gelu(self.fc1(x), approximate="tanh"))
        return out / torch.clamp(torch.linalg.vector_norm(out, dim=-1, keepdim=True), min=1e-8)


def init_adapter(generator: torch.Generator, d_in: int, cfg: TrainConfig = TrainConfig(), device=None) -> Adapter:
    """An `Adapter` with the reference's init (`init_adapter_params`): weights
    N(0, 2 / fan_in), zero biases, drawn on the CPU from `generator`, then
    moved to `device` (default: the card)."""
    dev = resolve_device(device)
    adapter = Adapter(d_in, cfg)
    with torch.no_grad():
        for lin in (adapter.fc1, adapter.fc2):
            w = torch.randn(lin.weight.shape, generator=generator, dtype=torch.float32)
            lin.weight.copy_(w * (2.0 / lin.in_features) ** 0.5)
            lin.bias.zero_()
    return adapter.to(dev)


class TrainModel(nn.Module):
    """The trained modules, `vit` and `adapter`, in their tp split; `spec`
    maps each parameter name to its split (a tuple over the tensor's axes,
    "model" on the split one, as the reference's PartitionSpecs)."""

    def __init__(self, vit: ViT, adapter: Adapter, axis: ModelAxis, spec: Dict[str, tuple]):
        super().__init__()
        self.vit, self.adapter = vit, adapter
        self.axis, self.spec = axis, spec

    def split_dim(self, name: str) -> Optional[int]:
        s = self.spec[name]
        return s.index("model") if "model" in s else None


def _model_axis(mesh) -> ModelAxis:
    if mesh is None:
        return ModelAxis()
    group = mesh.get_group("model")
    return ModelAxis(group, dist.get_rank(group), dist.get_world_size(group))


def _split_spec(prefix: str, module: nn.Module) -> Dict[str, tuple]:
    if isinstance(module, ColumnParallelLinear):
        return {f"{prefix}.weight": ("model", None), f"{prefix}.bias": ("model",)}
    if isinstance(module, RowParallelLinear):
        return {f"{prefix}.weight": (None, "model"), f"{prefix}.bias": ()}
    return {}


def _check_trainable(cfg: ViTConfig) -> None:
    """The tp split knows the GELU MLP's `fc1` / `fc2` and no register token."""
    if cfg.ffn != "mlp" or cfg.num_register_tokens:
        raise NotImplementedError(
            f"the trainer splits a GELU-MLP ViT without registers; this config has ffn={cfg.ffn!r} and "
            f"{cfg.num_register_tokens} register tokens (e.g. dinov2_vitg14_reg), which it would shard wrongly")


def shard_vit_params(vit: ViT, adapter: Adapter, mesh=None) -> Tuple[TrainModel, Dict[str, tuple]]:
    """The full-width `vit` and `adapter` in the tp layout of this rank on
    `mesh`'s "model" axis (reference `:101`): their split Linears replaced
    by this rank's blocks (every rank must pass the same full weights).
    Returns (the model, the split spec). A SwiGLU or register ViT raises
    NotImplementedError."""
    cfg = vit.cfg
    _check_trainable(cfg)
    axis = _model_axis(mesh)
    for blk in vit.blocks:
        blk.attn = ParallelAttention(blk.attn, cfg, axis)
        blk.fc1 = ColumnParallelLinear(blk.fc1, axis)
        blk.fc2 = RowParallelLinear(blk.fc2, axis)
    adapter.fc1 = ColumnParallelLinear(adapter.fc1, axis)
    adapter.fc2 = RowParallelLinear(adapter.fc2, axis)
    spec = {}
    for root, module in (("vit", vit), ("adapter", adapter)):
        for name, _ in module.named_parameters():
            spec[f"{root}.{name}"] = ()
        for name, sub in module.named_modules():
            spec.update(_split_spec(f"{root}.{name}", sub))
    return TrainModel(vit, adapter, axis, spec), spec


def _adamw(model: nn.Module, cfg: TrainConfig) -> torch.optim.AdamW:
    return torch.optim.AdamW(model.parameters(), lr=cfg.learning_rate, betas=ADAM_BETAS, eps=ADAM_EPS,
                             weight_decay=cfg.weight_decay)


def create_train_state(generator: torch.Generator, vit_cfg: ViTConfig, mesh=None,
                       cfg: TrainConfig = TrainConfig(), device=None):
    """(state, split spec, optimizer) (reference `:112`): the ViT and the
    adapter drawn from `generator` on the CPU (the ViT first), split over
    `mesh`'s "model" axis (None: one device), on `device` (default: the
    card), and AdamW over this rank's parameters. A SwiGLU or register ViT
    raises NotImplementedError."""
    _check_trainable(vit_cfg)
    dev = resolve_device(device)
    vit = init_vit(vit_cfg, generator, device="cpu")
    adapter = init_adapter(generator, vit_cfg.hidden_size, cfg, device="cpu")
    model, spec = shard_vit_params(vit, adapter, mesh)
    model = model.to(dev).train()
    optimizer = _adamw(model, cfg)
    return TrainState(model=model, optimizer=optimizer, step=0), spec, optimizer


# ---------------------------------------------------------------------------
# Loss and step
# ---------------------------------------------------------------------------


def info_nce_loss(adapter: nn.Module, patches_a: torch.Tensor, patches_b: torch.Tensor, pix_idx: torch.Tensor,
                  temperature: float, data_group=None):
    """(loss, accuracy) of the reference's `loss_fn` (`:141-158`) from the
    ViT's patches [B, h, w, D] of the two views and the corresponding patch
    indices pix_idx [B, K]: the `pix_idx` rows of each view through the
    adapter, logits = za @ zb.T / T over the B*K pairs, the symmetric
    cross-entropy against the diagonal and the share of rows whose argmax
    is it. With `data_group`, B is this rank's block and the pairs span
    every data rank's (`_GatherData`)."""
    b, gh, gw, d = patches_a.shape
    k = pix_idx.shape[1]
    idx = pix_idx.to(torch.int64)
    rows = [_TakeRows.apply(p.reshape(b, gh * gw, d), idx) for p in (patches_a, patches_b)]
    z = adapter(torch.cat(rows)).reshape(2, b * k, -1)
    if data_group is not None:
        z = _GatherData.apply(z, data_group, dist.get_rank(data_group), 1)
    za, zb = z.unbind(0)
    logits = za @ zb.T / temperature
    labels = torch.arange(za.shape[0], device=za.device)
    loss = 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels))
    acc = (logits.argmax(dim=1) == labels).to(torch.float32).mean()
    return loss, acc


def reduce_gradients(model: nn.Module, group) -> None:
    """Every parameter's gradient summed over `group` ("data"), in one
    all-reduce of the flattened gradients."""
    if group is None:
        return
    grads = [p.grad for p in model.parameters()]
    flat = torch.cat([g.reshape(-1) for g in grads])
    collectives.all_reduce(flat, SUM, group)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def _local_rows(x, mesh, device):
    x = torch.as_tensor(x)
    if mesh is not None:
        x = shard_rows(x, mesh, "data")
    return x.to(device)


def make_train_step(vit_cfg: ViTConfig, mesh=None, cfg: TrainConfig = TrainConfig(), optimizer=None):
    """`step(state, images_a, images_b, pix_idx, timer=None) -> (state,
    {"loss", "accuracy"})` (reference `:130`): images_a / b [B, H, W, 3]
    (two views of the same scenes, the global batch on every rank),
    pix_idx [B, K] flattened patch indices of corresponding patches. One
    forward of both views, the InfoNCE over the global batch, backward, the
    gradients summed over "data", one AdamW step (`optimizer`, default the
    state's); the state is updated in place and returned. With a
    `utils.profiling.Timer`, each stage (forward, backward,
    gradient_all_reduce, optimizer) is a span that ends in a synchronize
    (`utils.profiling.span`)."""
    data_group = None if mesh is None else mesh.get_group("data")

    def train_step(state: TrainState, images_a, images_b, pix_idx, timer=None):
        model = state.model
        if model.vit.cfg != vit_cfg:
            raise ValueError(f"the state's ViT is {model.vit.cfg}, the step's {vit_cfg}")
        opt = state.optimizer if optimizer is None else optimizer
        dev = model.vit.pos_embed.device
        if timer is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        with span("forward", timer, dev):
            a, b, idx = (_local_rows(x, mesh, dev) for x in (images_a, images_b, pix_idx))
            opt.zero_grad(set_to_none=True)
            patches_a, patches_b = model.vit(torch.cat([a, b]))["patches"].chunk(2)
            loss, acc = info_nce_loss(model.adapter, patches_a, patches_b, idx, cfg.temperature, data_group)
        with span("backward", timer, dev):
            loss.backward()
        with span("gradient_all_reduce", timer, dev):
            reduce_gradients(model, data_group)
        with span("optimizer", timer, dev):
            opt.step()
        state.step += 1
        return state, {"loss": loss.detach(), "accuracy": acc}

    return train_step


# ---------------------------------------------------------------------------
# Full tensors, checkpoint / resume
# ---------------------------------------------------------------------------


def gather_full(model: TrainModel, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """{name: this rank's block} -> {name: the full tensor on the CPU},
    the blocks all-gathered over "model" (every model rank must call)."""
    out = {}
    for name, t in tensors.items():
        dim = model.split_dim(name)
        if dim is not None and model.axis.group is not None:
            t = collectives.all_gather(t.detach().contiguous(), model.axis.group, dim=dim)
        out[name] = t.detach().cpu().clone()
    return out


def local_block(model: TrainModel, name: str, full: torch.Tensor) -> torch.Tensor:
    """This rank's block of the full tensor of parameter `name`."""
    dim = model.split_dim(name)
    return full if dim is None else _block(full, dim, model.axis)


def full_state(state: TrainState) -> dict:
    """The whole state, gathered: {"params", "exp_avg", "exp_avg_sq"} by
    full parameter name, "adam_step" (None before the first step) and "step"."""
    named = dict(state.model.named_parameters())
    moments = {"exp_avg": {}, "exp_avg_sq": {}}
    adam_step = None
    for name, p in named.items():
        st = state.optimizer.state.get(p)
        if st:
            adam_step = float(st["step"])
            for key in moments:
                moments[key][name] = st[key]
    return {"params": gather_full(state.model, named),
            **{key: gather_full(state.model, m) for key, m in moments.items()},
            "adam_step": adam_step, "step": int(state.step)}


def load_full_state(state: TrainState, params: Dict[str, object], exp_avg=None, exp_avg_sq=None,
                    adam_step: Optional[float] = None, step: int = 0) -> TrainState:
    """Set `state` from full tensors (numpy or torch, by full parameter
    name), each cut to this rank's block; moments None: a fresh optimizer."""
    model = state.model
    named = list(model.named_parameters())

    def block(src, name):
        return local_block(model, name, torch.as_tensor(src[name], dtype=torch.float32))

    with torch.no_grad():
        for name, p in named:
            p.copy_(block(params, name))
    sd = state.optimizer.state_dict()
    sd["state"] = {}
    if exp_avg is not None:
        sd["state"] = {i: {"step": torch.tensor(float(adam_step), dtype=torch.float32),
                           "exp_avg": block(exp_avg, name), "exp_avg_sq": block(exp_avg_sq, name)}
                       for i, (name, _) in enumerate(named)}
    state.optimizer.load_state_dict(sd)
    state.step = int(step)
    return state


def save_checkpoint(ckpt_dir, state: TrainState, step: int = None) -> str:
    """The full train state (gathered parameters, AdamW moments, step) as
    `ckpt_dir/step_%08d/state.pt`, written by global rank 0; every rank of
    a split state must call it. Returns the directory."""
    step = int(state.step) if step is None else int(step)
    path = Path(ckpt_dir).absolute() / f"step_{step:08d}"
    full = full_state(state)
    split = state.model.axis.group is not None
    if not split or dist.get_rank() == 0:
        path.mkdir(parents=True, exist_ok=True)
        tmp = path / f"state.pt.tmp{os.getpid()}"
        torch.save(full, tmp)
        os.replace(tmp, path / "state.pt")
    if split:  # a barrier: no rank goes on before the file is there
        collectives.all_reduce(torch.zeros(1, device=state.model.vit.pos_embed.device), SUM, None)
    return str(path)


def restore_checkpoint(path, target: TrainState) -> TrainState:
    """`target` (any split) set from the checkpoint directory `path`."""
    full = torch.load(Path(path).absolute() / "state.pt", map_location="cpu", weights_only=True)
    exp_avg = full["exp_avg"] if full["adam_step"] is not None else None
    return load_full_state(target, full["params"], exp_avg, full["exp_avg_sq"], full["adam_step"], full["step"])


def latest_checkpoint(ckpt_dir):
    steps = sorted(Path(ckpt_dir).glob("step_*"))
    return str(steps[-1]) if steps else None
