"""What the JAX package's ("data", "model") mesh does for the train step, over
torch.distributed (port of dfu3d_tpu/parallel/mesh.py).

JAX shards one global batch over the mesh's data axis and runs one program:
every batch statistic and every loss normaliser is taken over the global
batch, and the parameters and BN statistics stay replicated. Here each rank
holds its block of rows of the global batch (rank r the r-th block), and
the step computes what that program computes:

* `global_sum` is a differentiable all-reduce: the BN layers sum their
  statistics and the losses their normalisers with it, so rank r's loss
  L_r is its share of the global loss (Σ_r L_r is JAX's loss) and its
  backward carries the other ranks' share of the statistics' gradient;
* `all_reduce_grads_` sums the gradients, so every rank holds JAX's
  gradient before the clip and the optimizer;
* `local_rows` / `global_draw` give a rank its rows of a draw made at the
  global batch's shape, as JAX draws it;
* `broadcast_state_` replicates rank 0's weights and buffers.

`world()` is 1 without a process group, and then every helper is the
identity: the one-process step runs exactly as it did. A model trains at a
world above 1 only when each of its modules is audited for the global batch
(a class attribute GLOBAL_BATCH set in the class itself, or a stateless
torch layer); `check_global_batch` raises otherwise.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def world() -> int:
    return dist.get_world_size() if is_distributed() else 1


class _GlobalSum(torch.autograd.Function):
    """Σ over ranks; the backward sums the upstream gradients over ranks."""

    @staticmethod
    def forward(ctx, x):
        y = x.contiguous().clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over ranks, differentiable; `t` itself at world 1."""
    return t if world() == 1 else _GlobalSum.apply(t)


@torch.no_grad()
def rows_before(n: torch.Tensor) -> torch.Tensor:
    """Σ of the 0-dim count `n` over the ranks before this one (0 at
    world 1), one all-reduce of a (world,) vector."""
    if world() == 1:
        return torch.zeros_like(n)
    counts = torch.zeros(world(), dtype=n.dtype, device=n.device)
    counts[rank()] = n
    dist.all_reduce(counts)
    return counts[:rank()].sum()


def local_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's block of rows of a tensor made at the global batch's
    leading size (world · local)."""
    n = world()
    if n == 1:
        return x
    b = x.shape[0] // n
    return x[rank() * b:(rank() + 1) * b]


def global_draw(draw, shape):
    """`draw(shape)` with the leading (batch) size scaled to the global
    batch, and this rank's rows of it: every rank draws the one global
    stream from its shared generator, as JAX draws at the global shape."""
    shape = tuple(shape)
    return local_rows(draw((shape[0] * world(),) + shape[1:]))


def _buckets(tensors):
    by_key = {}
    for t in tensors:
        by_key.setdefault((t.dtype, t.device), []).append(t)
    return by_key.values()


@torch.no_grad()
def broadcast_state_(module: nn.Module, src: int = 0) -> None:
    """Copy rank `src`'s parameters and buffers to every rank (after a
    build, a checkpoint load or seeded weights). No-op without a group."""
    if not is_distributed():
        return
    for group in _buckets([t.data for t in list(module.parameters()) + list(module.buffers())]):
        flat = _flatten_dense_tensors(group)
        dist.broadcast(flat, src)
        for t, v in zip(group, _unflatten_dense_tensors(flat, group)):
            t.copy_(v)


@torch.no_grad()
def all_reduce_grads_(params) -> None:
    """Sum every parameter's gradient over ranks, one flat buffer per dtype
    (a missing gradient counts as zeros). No-op without a group."""
    if not is_distributed():
        return
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    for group in _buckets([p.grad for p in params]):
        flat = _flatten_dense_tensors(group)
        dist.all_reduce(flat)
        for g, v in zip(group, _unflatten_dense_tensors(flat, group)):
            g.copy_(v)


@torch.no_grad()
def sum_scalars(values: dict) -> dict:
    """{key: 0-dim tensor} summed over ranks in one all-reduce (the global
    loss and loss terms from each rank's share). No-op without a group."""
    if not is_distributed() or not values:
        return values
    keys = list(values)
    flat = torch.stack([values[k].detach().float() for k in keys])
    dist.all_reduce(flat)
    return {k: flat[i] for i, k in enumerate(keys)}


@torch.no_grad()
def mean_floats(values):
    """Host floats averaged over ranks (the trainer's data and batch
    times); the values themselves without a group."""
    if not is_distributed():
        return list(values)
    t = torch.tensor(list(values), dtype=torch.float64)
    if dist.get_backend() == "nccl":
        t = t.cuda()
    dist.all_reduce(t)
    return (t / world()).tolist()


def barrier() -> None:
    if is_distributed():
        dist.barrier()


# stateless torch layers: their output on a row depends on that row only
_TORCH_LAYERS = (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d, nn.ConvTranspose1d,
                 nn.ConvTranspose2d, nn.ConvTranspose3d, nn.Sequential, nn.ModuleList,
                 nn.ModuleDict, nn.Identity, nn.ReLU)


def unaudited(model: nn.Module) -> list:
    """Names of the module classes in `model` not audited for the global
    batch: neither a stateless torch layer nor a class that sets
    GLOBAL_BATCH = True itself (a subclass inherits no audit)."""
    out = set()
    for m in model.modules():
        t = type(m)
        if t in _TORCH_LAYERS or t.__dict__.get("GLOBAL_BATCH", False):
            continue
        out.add(t.__name__)
    return sorted(out)


def check_global_batch(model: nn.Module) -> None:
    """Raise NotImplementedError at a world above 1 when some module of
    `model` is not audited: it would train with rank-local batch
    statistics, loss normalisers or draws, a step other than JAX's."""
    if world() == 1:
        return
    missing = unaudited(model)
    if missing:
        raise NotImplementedError(
            f"{type(model).__name__} is not audited for data-parallel training over "
            f"{world()} ranks (unaudited modules: {', '.join(missing)}); train it on one "
            "process")
