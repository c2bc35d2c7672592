"""N ranks of one machine as spawned processes joined by a FileStore (no
TCP port): the data-parallel path's checks on the CPU (gloo) and on a card
shared by both ranks (gloo over CUDA tensors, the collectives staged through
the host).

    results = run_ranks(fn, world=2, args=(...), device="cpu")

Each rank joins the group through `init_distributed`, calls
fn(rank, world, *args, **kwargs) and sends back its result, with every tensor in it
turned into a numpy array. A rank that raises, dies or runs past the time
limit fails the call: the others are stopped and the error is raised here.
"""
from __future__ import annotations

import multiprocessing as mp
import queue
import shutil
import tempfile
import time
import traceback
from pathlib import Path

import torch

from .distributed import destroy_distributed, init_distributed


def to_host(tree):
    """`tree` with every tensor a numpy array (dicts, lists and tuples
    walked)."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(to_host(v) for v in tree)
    return tree


def _rank_main(rank, world, store, device, backend, threads, fn, args, kwargs, out_q):
    try:
        if threads:
            torch.set_num_threads(threads)
        init_distributed(device, backend=backend, init_method=f"file://{store}", rank=rank,
                         world_size=world)
        out_q.put((rank, True, to_host(fn(rank, world, *args, **kwargs))))
    except BaseException:  # noqa: BLE001 - sent to the parent, which raises it
        out_q.put((rank, False, traceback.format_exc()))
    finally:
        destroy_distributed()


def run_ranks(fn, world: int, args=(), kwargs=None, device="cpu", backend: str | None = None,
              timeout_s: float = 600.0, threads: int | None = None) -> list:
    """fn(rank, world, *args, **kwargs) in `world` spawned processes over `backend`
    (gloo for the CPU, nccl for a card, unless named); returns the results
    by rank. `fn` must be importable by name (a module-level function)."""
    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    tmp = Path(tempfile.mkdtemp(prefix="dfu3d_ranks_"))
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, str(tmp / "store"), str(device), backend, threads, fn,
                               tuple(args), dict(kwargs or {}), out_q))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        results, deadline = {}, time.time() + timeout_s
        while len(results) < world:
            try:
                r, ok, value = out_q.get(timeout=1.0)
            except queue.Empty:
                dead = [i for i, p in enumerate(procs) if i not in results and not p.is_alive()]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} before sending a result")
                if time.time() > deadline:
                    raise TimeoutError(f"the ranks ran past {timeout_s} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {r} of {world} failed:\n{value}")
            results[r] = value
        for p in procs:
            p.join(timeout=60)
        return [results[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        out_q.close()
        shutil.rmtree(tmp, ignore_errors=True)


def rank_rows(batch, rank: int, world: int):
    """Rank `rank`'s block of rows of a global batch (a NamedTuple of
    tensors with the batch axis first), as JAX's shard_batch places it."""
    b = batch[0].shape[0] // world
    if b * world != batch[0].shape[0]:
        raise ValueError(f"a batch of {batch[0].shape[0]} does not divide over {world} ranks")
    return type(batch)(*(t[rank * b:(rank + 1) * b] for t in batch))


def train_rank(rank: int, world: int, build, batches, device="cpu", dtype=torch.float32,
               keep_grads: bool = False):
    """Train the state `build(device)` returns (a TrainState, its model in
    train mode) one step on this rank's rows of each global batch in
    `batches`, rank 0's weights broadcast first. Returns {"metrics": [each
    step's metrics as floats], "state": the model's state_dict, "launches":
    [each step's (B1, B2) kernel launches], "ms": [each step's host
    milliseconds, the card waited for], "peak_gib": the card's peak memory
    over the steps (0 on the CPU), and with `keep_grads` "grads": each
    update's gradients (summed over ranks) by parameter name}."""
    from ..core.geometry import iou_kernel
    from ..core.voxel import gather_gemm_kernel
    from ..train.train_state import make_train_step
    from . import mesh

    state = build(device)
    mesh.broadcast_state_(state.model)
    grads, opt_step = [], state.optimizer.step
    if keep_grads:
        def step_keeping_grads():
            grads.append({n: p.grad.detach().clone()
                          for n, p in state.model.named_parameters() if p.grad is not None})
            return opt_step()
        state.optimizer.step = step_keeping_grads
    step = make_train_step(state.model, state.optimizer, device=device, dtype=dtype)
    rows = [rank_rows(b, rank, world) for b in batches]
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    metrics, launches, ms = [], [], []
    for batch in rows:
        iou_kernel.launches = gather_gemm_kernel.launches = 0
        t0 = time.perf_counter()
        got = step(batch)
        metrics.append({key: v.tolist() for key, v in got.items()})   # waits for the card
        ms.append((time.perf_counter() - t0) * 1e3)
        launches.append((iou_kernel.launches, gather_gemm_kernel.launches))
    peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0
    out = {"metrics": metrics, "state": dict(state.model.state_dict()), "launches": launches,
           "ms": ms, "peak_gib": peak}
    if keep_grads:
        out["grads"] = grads
    return out
