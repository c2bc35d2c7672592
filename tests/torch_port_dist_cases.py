"""Models, batches and comparisons of the data-parallel tests
(tests/test_torch_port_distributed*.py). Spawned ranks import this module,
so it imports torch, numpy and the port only, never JAX.

Tolerances of a world-2 run against the world-1 run on the joined batch
(the port on both sides, fp32): every loss term and the gradient norm
within LOSS_TOL relative at every step; each gradient leaf of the first
update (both runs from the same weights) within GRAD_TOL of that leaf's
largest |entry| (the global statistics and normalisers sum two halves
where one process sums the whole), a bias within GRAD_TOL of its module's
weight gradient (a conv bias in front of a BN, or a BN bias whose shift
the next BN takes out: exactly 0 in exact arithmetic, rounding noise
here); later updates start from weights that differ where Adam moved such
noise by ±lr, so their gradients only decide which parameters are
compared closely. BN running statistics within 1e-5 (the
variances of 1e-5 of var + (1 - keep) · mean_b²: the one-pass batch
variance E[x²] - mean_b² rounds with E[x²]); parameters within PARAM_TOL
(1 + |w|) where both runs' gradients agree to 2 %, and within 2 lr per
update elsewhere (Adam moves an entry by about lr whatever its gradient's
size, so rounding noise on a gradient near 0 can flip its sign). The
ranks' own states must be equal bit for bit (one all-reduce result on
every rank).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from dfu3d_tpu_torch.flagship import flagship, seeded_weights_
from dfu3d_tpu_torch.models import build_network
from dfu3d_tpu_torch.parallel.launch import run_ranks, train_rank
from dfu3d_tpu_torch.train.train_state import create_train_state
from dfu3d_tpu_torch.utils.config import CfgDict, cfg_from_yaml_file
from dfu3d_tpu_torch.zoo import POINTRCNN_CFG, voxel_centerpoint

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 1e-5
TOTAL_STEPS = 100
THREADS = 2


def shift_bn_biases_(model, shift=3.0):
    """+shift on every BN bias, so that no ReLU input lies within rounding
    of 0 (tests/test_torch_port_train_slice.py)."""
    with torch.no_grad():
        for m in model.modules():
            if hasattr(m, "running_mean") and hasattr(m, "bias"):
                m.bias += shift


def build_state(device, kind, seed=0, state_dict=None, model_cfg=None):
    """A TrainState of `kind` ("pillar": the flagship at full widths on its
    tiny grid; "voxel": voxel CenterPoint at full widths on its tiny grid,
    2048 voxels; "pointrcnn": the PointRCNN of `model_cfg`, a plain dict,
    with the shipped config's optimizer) in train mode: the weights of
    `state_dict` (numpy), else seeded weights with BN biases +3."""
    torch.manual_seed(seed)
    if kind == "pillar":
        cfg, _, model = flagship(tiny=True, device=device, train=True)
        optim = cfg.OPTIMIZATION
    elif kind == "voxel":
        cfg, grid, _ = voxel_centerpoint(tiny=True, device="cpu")
        model = build_network(cfg.MODEL, cfg.CLASS_NAMES, grid, device=device, train=True,
                              max_voxels=2048)
        optim = cfg.OPTIMIZATION
    else:
        cfg = CfgDict(model_cfg)
        model = build_network(cfg, ["Car", "Pedestrian", "Cyclist"], None, device=device,
                              train=True)
        optim = cfg_from_yaml_file(POINTRCNN_CFG, CfgDict()).OPTIMIZATION
    if state_dict is not None:
        model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in state_dict.items()})
    else:
        seeded_weights_(model, seed)
        shift_bn_biases_(model)
        if kind == "pointrcnn":   # every point proposes a mean-size box at itself
            with torch.no_grad():
                model.point_head.reg_out.weight.zero_()
                model.point_head.reg_out.bias.zero_()
    return create_train_state(model.to(device), optim, TOTAL_STEPS)


def builder(kind, **kwargs):
    return functools.partial(build_state, kind=kind, **kwargs)


def run_world(build, batches, world, **kwargs):
    """train_rank at `world` ranks (spawned, gloo on the CPU), or in this
    process without a group at world 1."""
    if world == 1:
        from dfu3d_tpu_torch.parallel.launch import to_host
        return [to_host(train_rank(0, 1, build, batches, **kwargs))]
    return run_ranks(train_rank, world, args=(build, batches), kwargs=kwargs, threads=THREADS)


def assert_ranks_equal(runs):
    """Every rank holds the same state, bit for bit."""
    for r in runs[1:]:
        assert r["state"].keys() == runs[0]["state"].keys()
        for k, v in runs[0]["state"].items():
            np.testing.assert_array_equal(r["state"][k], v, err_msg=k)


def assert_runs_match(got, want, lr, keeps):
    """A world-N run (rank 0's result) against the world-1 run on the joined
    batches, at the tolerances of the module docstring. `keeps` maps each
    BN module's name to its keep."""
    assert len(got["metrics"]) == len(want["metrics"])
    for g, w in zip(got["metrics"], want["metrics"]):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=LOSS_TOL, err_msg=k)
    sure = {}
    for step, (gg, wg) in enumerate(zip(got["grads"], want["grads"])):
        assert gg.keys() == wg.keys()
        for k, w in wg.items():
            agree = np.abs(gg[k] - w) <= 0.02 * np.abs(w)
            sure[k] = sure.get(k, agree) & agree
            if step:    # from the same weights only: see the module docstring
                continue
            scale = np.abs(w).max()
            module, leaf = k.rsplit(".", 1)
            weight = wg.get(f"{module}.weight")
            if leaf == "bias" and weight is not None:
                scale = max(scale, np.abs(weight).max())
            np.testing.assert_allclose(gg[k], w, rtol=0, atol=GRAD_TOL * max(scale, 1e-30),
                                       err_msg=k)
    steps = len(got["grads"])
    for k, w in want["state"].items():
        g = got["state"][k]
        module, leaf = k.rsplit(".", 1)
        if leaf in ("running_mean", "running_var"):
            keep = keeps[module]
            tol = 1e-5 * (1 + np.abs(w))
            if leaf == "running_var":
                tol = tol + 1e-5 * (1 - keep) * np.abs(want["state"][f"{module}.running_mean"]) ** 2
            assert (np.abs(g - w) <= tol).all(), (k, np.abs(g - w).max())
            continue
        tol = PARAM_TOL * (1 + np.abs(w).max())
        s = sure.get(k, np.ones(w.shape, bool))
        np.testing.assert_allclose(g[s], w[s], rtol=0, atol=tol, err_msg=k)
        assert (np.abs(g - w)[~s] <= 2 * lr * steps + tol).all(), k


def bn_keeps(model):
    return {name: m.keep for name, m in model.named_modules() if hasattr(m, "keep")}


def eval_rank(rank, world, cfg_file, state_dict, batch_size):
    """eval_one_epoch of the tiny pillar config's model with `state_dict` on
    this rank's shard of the val split. Returns {"result", "annos",
    "indices": the shard's frame indices}."""
    from dfu3d_tpu_torch.data.loader import build_dataloader
    from dfu3d_tpu_torch.tools.common import build_model
    from dfu3d_tpu_torch.train.eval_utils import eval_one_epoch

    cfg = cfg_from_yaml_file(cfg_file, CfgDict())
    dataset, loader = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size=batch_size,
                                       workers=1, training=False, process_index=rank,
                                       process_count=world)
    model = build_model(cfg, "test", "cpu")
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in state_dict.items()})
    _, result, annos = eval_one_epoch(model, dataset, loader, cfg, None, device="cpu")
    return {"result": result, "annos": annos, "indices": loader._local_indices()}


def cli_rank(rank, world, work, cfg_file, argv, train_argv):
    """tools.train (with `train_argv` and `argv`) then tools.test --eval_all
    (with `argv`) from `work`. Returns {"epochs": the train epochs' stats,
    "tested": [(epoch, result dir, result)]}."""
    import os

    from dfu3d_tpu_torch.tools import test as test_cli, train as train_cli

    os.chdir(work)
    trained = train_cli.main(["--cfg_file", cfg_file, "--epochs", "1", *train_argv, *argv])
    tested = test_cli.main(["--cfg_file", cfg_file, "--eval_all", "--max_waiting_mins", "0",
                            *argv])
    return {"epochs": trained["epochs"], "tested": [(e, str(d), r) for e, d, r in tested]}


BN_CASES = ("BatchNorm", "MaskedBatchNorm", "SparseBatchNorm", "DynPillarVFE")
PILLARS_PER_FRAME = (70, 50, 30, 40)   # a 40-pillar cap per frame binds over the batch
PILLAR_CAP = 40


def module_inputs(case, seed=0):
    """The global batch of one module case: (input rows, mask rows or
    None, upstream-gradient rows), numpy, 4 frames."""
    rng = np.random.RandomState(seed)
    if case == "BatchNorm":
        x = rng.normal(1.0, 2.0, (4, 8, 5, 6)).astype(np.float32)
        return x, None, rng.normal(size=x.shape).astype(np.float32)
    if case in ("MaskedBatchNorm", "SparseBatchNorm"):
        x = rng.normal(1.0, 2.0, (4, 50, 8)).astype(np.float32)
        mask = rng.uniform(size=(4, 50)) < 0.7
        mask[3] = False          # a frame with no live row
        return x, mask, rng.normal(size=x.shape).astype(np.float32)
    # DynPillarVFE on the tiny flagship grid: frame i holds points in
    # PILLARS_PER_FRAME[i] distinct pillars, 3 points each, and some padding
    pts = np.zeros((4, 260, 4), np.float32)
    valid = np.zeros((4, 260), bool)
    for i, n_pil in enumerate(PILLARS_PER_FRAME):
        cells = rng.choice(64 * 128, n_pil, replace=False)
        cx, cy = cells % 64, cells // 64
        for j in range(3):
            rows = slice(j * n_pil, (j + 1) * n_pil)
            pts[i, rows, 0] = (cx + rng.uniform(0.1, 0.9, n_pil)) * 0.2
            pts[i, rows, 1] = (cy + rng.uniform(0.1, 0.9, n_pil)) * 0.2 - 12.8
            pts[i, rows, 2] = rng.uniform(-3, 1, n_pil)
            pts[i, rows, 3] = rng.uniform(0, 1, n_pil)
            valid[i, rows] = True
    return pts, valid, rng.normal(size=(4, 128, 64, 64)).astype(np.float32)


def build_module(case, seed=0):
    from dfu3d_tpu_torch.core.voxel import VoxelGrid
    from dfu3d_tpu_torch.flagship import TINY_RANGE, VOXEL_SIZE
    from dfu3d_tpu_torch.models.backbone_2d import BatchNorm
    from dfu3d_tpu_torch.models.sparse_backbone import SparseBatchNorm
    from dfu3d_tpu_torch.models.vfe import DynPillarVFE, MaskedBatchNorm

    torch.manual_seed(seed)
    if case == "DynPillarVFE":
        m = DynPillarVFE((64, 64), VoxelGrid.create(TINY_RANGE, VOXEL_SIZE),
                         max_pillars=PILLAR_CAP)
    else:
        m = {"BatchNorm": lambda: BatchNorm(8, eps=1e-3, keep=0.9),
             "MaskedBatchNorm": lambda: MaskedBatchNorm(8),
             "SparseBatchNorm": lambda: SparseBatchNorm(8)}[case]()
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape) * 0.5 + (1.0 if p.dim() == 1 else 0.0))
        for name, b in m.named_buffers():
            b.copy_(torch.rand(b.shape) + (0.5 if name.endswith("var") else 0.0))
    return m.train()


def module_rank(rank, world, cases=BN_CASES):
    """Each module case's forward and backward on this rank's rows: {case:
    {"y", "x_grad", the running buffers, the parameters' gradients}, and
    DynPillarVFE's eval forward "eval_y"}. At world 1 (no group) the whole
    batch."""
    out = {}
    for case in cases:
        x, mask, g = module_inputs(case)
        b = x.shape[0] // world
        rows = slice(rank * b, (rank + 1) * b)
        m = build_module(case)
        xt = torch.from_numpy(x[rows]).requires_grad_(True)
        if case == "DynPillarVFE":
            y = m(xt, torch.from_numpy(mask[rows]))
        elif mask is None:
            y = m(xt)
        else:
            y = m(xt, torch.from_numpy(mask[rows]))
        (y * torch.from_numpy(g[rows])).sum().backward()
        got = {"y": y.detach(), "x_grad": xt.grad}
        if case == "DynPillarVFE":
            # eval: the cap is this rank's batch's (a fresh module's weights)
            with torch.no_grad():
                got["eval_y"] = build_module(case).eval()(torch.from_numpy(x[rows]),
                                                          torch.from_numpy(mask[rows]))
        got.update({f"buf.{k}": v for k, v in m.named_buffers()})
        got.update({f"grad.{k}": p.grad for k, p in m.named_parameters()})
        out[case] = got
    return out
