"""Process-group initialisation (port of dfu3d_tpu/parallel/distributed.py,
itself the reference's common_utils.init_dist_pytorch / init_dist_slurm).

One process drives one card. `init_distributed` reads the rank and the world
from torchrun's variables (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT) or from SLURM's (SLURM_NTASKS, SLURM_PROCID, SLURM_LOCALID,
SLURM_STEP_NODELIST, the first node being the rendezvous host), or from its
arguments, and joins the process group over the backend its caller names:
"nccl" for a card, "gloo" for the CPU unless the caller names another. A
backend that fails raises; nothing switches to another backend or to the
CPU. With one process and no explicit rendezvous it is a no-op.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..device import resolve_device

DEFAULT_PORT = "12567"   # the JAX package's COORDINATOR_PORT default


def slurm_head(nodelist: str) -> str:
    """The first host of a SLURM node list ("node[3-5],node7" → "node3"),
    as the JAX package derives its coordinator."""
    return nodelist.split(",")[0].replace("[", "").split("-")[0]


def _from_env():
    """(rank, world, local_rank, init_method) from torchrun's or SLURM's
    variables, or None when neither launched this process."""
    env = os.environ
    if "WORLD_SIZE" in env and "RANK" in env:
        return (int(env["RANK"]), int(env["WORLD_SIZE"]), int(env.get("LOCAL_RANK", 0)),
                "env://")
    if "SLURM_NTASKS" in env:
        head = slurm_head(env.get("SLURM_STEP_NODELIST", "localhost"))
        port = env.get("MASTER_PORT", DEFAULT_PORT)
        return (int(env["SLURM_PROCID"]), int(env["SLURM_NTASKS"]),
                int(env.get("SLURM_LOCALID", 0)), f"tcp://{head}:{port}")
    return None


def init_distributed(device="cuda", backend: str | None = None, init_method: str | None = None,
                     rank: int | None = None, world_size: int | None = None):
    """Join the process group; returns (rank, world).

    `device` is where this rank computes ("cuda", the default, raises when
    there is no card; "cpu" only when asked). `backend` defaults to "nccl"
    for a card and "gloo" for the CPU. `init_method`, `rank` and
    `world_size` override the environment (a "file://" store lets ranks of
    one machine meet without a port); LOCAL_RANK or SLURM_LOCALID picks
    the card. A world of 1 without an explicit
    `init_method` is a no-op and returns (0, 1); in a process that has
    joined a group already it returns that group's (rank, world)."""
    dev = resolve_device(device)
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    found = _from_env()
    env_rank, env_world, env_local, env_method = found or (0, 1, 0, None)
    rank = env_rank if rank is None else int(rank)
    world = env_world if world_size is None else int(world_size)
    if world == 1 and init_method is None:
        return 0, 1
    init_method = init_method or env_method
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs device='cuda'")
    if dev.type == "cuda":
        torch.cuda.set_device(env_local)
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world)
    return dist.get_rank(), dist.get_world_size()


def destroy_distributed():
    """Leave the process group, if this process is in one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def all_gather_objects(obj):
    """One picklable object per rank, as a list ordered by rank (the
    reference's merge_results_dist through all_gather_object). One process:
    [obj] without a collective."""
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out
