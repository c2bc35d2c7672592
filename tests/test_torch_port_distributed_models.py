"""The data-parallel train step over two gloo ranks on the CPU against the
port's one-process step on the joined batch (spawned ranks joined by a
FileStore, no TCP port; tolerances in tests/torch_port_dist_cases.py):

* each global BN class (BatchNorm one-pass, MaskedBatchNorm one-pass over
  the masked rows, SparseBatchNorm two-pass) and DynPillarVFE with a pillar
  cap that binds over the batch and not within a rank's share: the
  forward, the running buffers, the input gradient and the parameters'
  gradients (summed over ranks); DynPillarVFE's eval cap, each rank's own;
* voxel CenterPoint (full widths, tiny grid) for two steps and PointRCNN
  (the tiny config with dropout and RoI-head BN) for one: every loss term,
  the summed gradients, the parameters and BN statistics; the ranks'
  states equal bit for bit;
* the ranks' shares of the RoI sampler's and the dropout's draws;
* make_multi_train_step and the trainer's K-step path against single
  steps, bit for bit (one process);
* the measures of the card's rounding probe (`parallel.rounding`).
"""
import json

import numpy as np
import pytest
import torch

from dfu3d_tpu_torch.data.batch import PointBatch
from dfu3d_tpu_torch.models import roi_head
from dfu3d_tpu_torch.parallel import mesh, rounding
from dfu3d_tpu_torch.parallel.launch import run_ranks, to_host
from dfu3d_tpu_torch.train.train_state import make_multi_train_step, make_train_step
from dfu3d_tpu_torch.train.trainer import train_model

import torch_port_dist_cases as cases
from test_pointrcnn import prcnn_cfg
from test_torch_port_cli import tiny_state
from test_torch_port_pointrcnn_train import fg_scene
from test_torch_port_sparse import ground_points
from test_torch_port_threads import few_threads  # noqa: F401 (autouse)
from test_torch_port_train_slice import _gt


@pytest.fixture(scope="module")
def module_runs():
    """Every module case at world 1 (this process) and on two ranks."""
    return to_host(cases.module_rank(0, 1)), run_ranks(cases.module_rank, 2,
                                                       threads=cases.THREADS)


@pytest.mark.parametrize("case", cases.BN_CASES)
def test_global_batch_modules_match_one_rank(module_runs, case):
    one, ranks = module_runs
    want = one[case]
    for key in ("y", "x_grad"):
        got = np.concatenate([r[case][key] for r in ranks])
        scale = np.abs(want[key]).max()
        np.testing.assert_allclose(got, want[key], rtol=0, atol=1e-5 * scale, err_msg=key)
    for key, w in want.items():
        if key.startswith("buf."):
            for r in ranks:   # replicated: every rank moves them alike
                np.testing.assert_allclose(r[case][key], w, rtol=1e-5, atol=1e-6, err_msg=key)
            np.testing.assert_array_equal(ranks[0][case][key], ranks[1][case][key])
        elif key.startswith("grad."):
            got = sum(r[case][key] for r in ranks)
            np.testing.assert_allclose(got, w, rtol=0, atol=1e-5 * np.abs(w).max(), err_msg=key)
    if case == "DynPillarVFE":
        # the cap binds in the global order: frames 0-2 whole, frame 3 partly,
        # where each rank's own cap (2 · 40) would cut frame 1
        live = (np.abs(want["y"]).sum(-1) > 0).reshape(4, -1).sum(1)
        assert live[0] == cases.PILLARS_PER_FRAME[0] and live[1] == cases.PILLARS_PER_FRAME[1]
        assert live[2] == cases.PILLARS_PER_FRAME[2] and 0 < live[3] < cases.PILLARS_PER_FRAME[3]
        assert live.sum() == 4 * cases.PILLAR_CAP


def test_eval_pillar_cap_is_each_ranks_own(module_runs):
    """In eval DynPillarVFE caps each rank's own batch, as JAX's eval runs
    each host's loader batch on its own: at world 2 a rank's grid equals
    one process's on that rank's frames alone, where rank 0's cap (2 · 40)
    cuts frame 1, which the training step's global cap (4 · 40) keeps whole."""
    _, ranks = module_runs
    x, mask, _ = cases.module_inputs("DynPillarVFE")
    for r, got in enumerate(ranks):
        rows = slice(2 * r, 2 * r + 2)
        with torch.no_grad():
            want = cases.build_module("DynPillarVFE").eval()(
                torch.from_numpy(x[rows]), torch.from_numpy(mask[rows])).numpy()
        np.testing.assert_allclose(got["DynPillarVFE"]["eval_y"], want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    live = (np.abs(ranks[0]["DynPillarVFE"]["eval_y"]).sum(-1) > 0).reshape(2, -1).sum(1)
    assert live[0] == cases.PILLARS_PER_FRAME[0]
    assert live[1] == 2 * cases.PILLAR_CAP - cases.PILLARS_PER_FRAME[0]
    trained = (np.abs(ranks[0]["DynPillarVFE"]["y"]).sum(-1) > 0).reshape(2, -1).sum(1)
    assert trained[1] == cases.PILLARS_PER_FRAME[1]


def test_rounding_probe_gaps_and_halves():
    """parallel.rounding's measures: a gradient gap over the leaf's largest
    entry (a bias's at least its module weight's), metrics relative, BN of
    1 + |x|; swap_halves puts the second half's rows first."""
    want = {"grads": {"conv.weight": np.array([2.0, -4.0]), "conv.bias": np.array([1e-6]),
                      "bn.bias": np.array([0.5])},
            "metrics": {"loss": 10.0}, "bn": {"bn.running_mean": np.array([1.0])}}
    got = {"grads": {"conv.weight": np.array([2.04, -4.0]), "conv.bias": np.array([2e-6]),
                     "bn.bias": np.array([0.51])},
           "metrics": {"loss": 10.001}, "bn": {"bn.running_mean": np.array([1.002])}}
    grads, metrics, bn = rounding.gaps(got, want)
    assert grads["conv.weight"] == pytest.approx(0.01)
    assert grads["conv.bias"] == pytest.approx(1e-6 / 4)
    assert grads["bn.bias"] == pytest.approx(0.02)
    assert metrics["loss"] == pytest.approx(1e-4) and bn == pytest.approx(1e-3)
    (batch,) = _voxel_batches(1, 4)
    (swapped,) = rounding.swap_halves([batch], 2)
    for t, u in zip(batch, swapped):
        assert torch.equal(u, torch.cat([t[2:], t[:2]]))


def _voxel_batches(n, b):
    out = []
    for i in range(n):
        rng = np.random.RandomState(31 + i)
        pts, valid = ground_points(rng, b)
        gt, gvalid = _gt(rng, b, 32, (-6, -6), (6, 6), 10)
        out.append(PointBatch.from_numpy(pts, valid, gt, gvalid))
    return out


def _prcnn_cfg():
    cfg = json.loads(json.dumps(prcnn_cfg()))
    cfg["ROI_HEAD"]["DP_RATIO"] = 0.3      # the FC stacks' dropout draws
    cfg["ROI_HEAD"]["USE_BN"] = True
    return cfg


def _prcnn_batches(n, b):
    return [fg_scene(np.random.RandomState(12 + i), b=b) for i in range(n)]


@pytest.mark.parametrize("kind", ["voxel", "pointrcnn"])
def test_two_ranks_train_as_one_on_the_joined_batch(kind):
    kwargs = {"model_cfg": _prcnn_cfg()} if kind == "pointrcnn" else {}
    build = cases.builder(kind, **kwargs)
    # PointRCNN's BN biases behind its grouped maxes get rounding noise for
    # a gradient (torch_port_dist_cases), which Adam turns into ±lr: from
    # its second step on the two runs' weights differ there, so it is held
    # for one step
    batches = _voxel_batches(2, 4) if kind == "voxel" else _prcnn_batches(1, 4)
    (one,) = cases.run_world(build, batches, 1, keep_grads=True)
    ranks = cases.run_world(build, batches, 2, keep_grads=True)
    cases.assert_ranks_equal(ranks)
    state = build("cpu")
    cases.assert_runs_match(ranks[0], one, state.optimizer.lr_fn(0), cases.bn_keeps(state.model))
    if kind == "pointrcnn":
        assert all(m["rcnn_reg_loss"] > 0 for m in one["metrics"])


@pytest.mark.parametrize("world", [2, 3])
def test_ranks_draw_their_rows_of_the_global_draw(monkeypatch, world):
    """A rank's RoI-sampler uniforms (B, 2, P) and dropout mask (B·M, C)
    are its rows of the one-process draw at the global batch's shape."""
    b, p, m, c = 2, 7, 3, 5
    full_u = roi_head.draw_roi_uniforms(torch.Generator().manual_seed(4), (world * b, 2, p),
                                        "cpu")
    full_k = roi_head.dropout_keep(torch.Generator().manual_seed(5), (world * b * m, c), 0.7,
                                   "cpu")
    monkeypatch.setattr(mesh, "world", lambda: world)
    for r in range(world):
        monkeypatch.setattr(mesh, "rank", lambda r=r: r)
        u = roi_head.draw_roi_uniforms(torch.Generator().manual_seed(4), (b, 2, p), "cpu")
        k = roi_head.dropout_keep(torch.Generator().manual_seed(5), (b * m, c), 0.7, "cpu")
        assert torch.equal(u, full_u[r * b:(r + 1) * b])
        assert torch.equal(k, full_k[r * b * m:(r + 1) * b * m])


def test_multi_step_and_the_trainers_k_path_equal_single_steps(tmp_path):
    """make_multi_train_step (K=3) gives the weights of 3 single steps bit for
    bit, the single steps' metric keys plus loss_steps; the trainer at
    steps_per_dispatch 3 over 7 batches (two calls and a tail step) gives
    those of 7 single steps."""
    root = tmp_path / "root"
    from dfu3d_tpu_torch.data import kitti_synthetic
    from dfu3d_tpu_torch.tools import create_infos
    from test_cli import _write_cfg

    kitti_synthetic.write_root(root, 14, 0, ["Car", "Pedestrian"], seed=2,
                               num_points=(800, 1200), num_boxes=(4, 7), near_cars=2)
    create_infos.main(["--cfg_file", str(_write_cfg(root, tmp_path)), "--splits", "train"])
    single, batches = tiny_state(root)
    multi, _ = tiny_state(root)
    batches = batches[:3]
    one = make_train_step(single.model, single.optimizer, device="cpu", dtype=torch.float32)
    singles = [one(b) for b in batches]
    got = make_multi_train_step(multi.model, multi.optimizer, 3, device="cpu",
                                dtype=torch.float32)(batches)
    assert set(got) == set(singles[-1]) | {"loss_steps"}
    assert torch.equal(got["loss_steps"], torch.stack([m["loss"] for m in singles]))
    for k, v in singles[-1].items():
        assert torch.equal(got[k], v), k
    for (k, a), b in zip(single.model.state_dict().items(), multi.model.state_dict().values()):
        assert torch.equal(a, b), k
    assert multi.step == single.step == 3

    seven = [batches[i % 3] for i in range(7)]
    runs = []
    for k in (1, 3):
        state, _ = tiny_state(root)
        stats = []
        train_model(state, seven, 1, tmp_path / f"ckpt{k}", device="cpu", dtype=torch.float32,
                    on_epoch=stats.append, steps_per_dispatch=k)
        runs.append((state, stats[0]))
    (s1, e1), (s3, e3) = runs
    assert e1["losses"] == e3["losses"] and e3["steps"] == 7 and s3.step == 7
    for (k, a), b in zip(s1.model.state_dict().items(), s3.model.state_dict().values()):
        assert torch.equal(a, b), k
