"""The port's data parallelism against the JAX package's sharded step, and
its process-group plumbing, on the CPU.

* The flagship CenterPoint-pillar (full widths, tiny grid) trained one
  step on two gloo ranks (spawned, a FileStore, no TCP port), B=2 on each,
  against JAX's `make_train_step` under `make_mesh(data=2)` + `shard_batch`
  on the joined B=4 batch, fp32 on both sides, from the same numpy weights
  (every BN bias +3, as tests/test_torch_port_train_slice.py): the loss and
  every loss term within 1e-5 relative, the gradient norm too, each
  gradient leaf within 1e-4 of its largest |entry|, the BN running
  statistics and the updated parameters as that test holds them (the
  parameters within 1e-5 where the two gradients agree to 2 %, within 2 lr
  elsewhere), and both ranks' states equal bit for bit.
* `init_distributed` from torchrun's and SLURM's variables (the process
  group's own init stubbed), its no-op at one process, its raise without
  a card unless the caller asks for the CPU; `all_gather_objects` at one
  process.
* The models this port has not audited for the global batch raise
  NotImplementedError at a world above 1; the audited ones hold no
  unaudited module.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import __graft_entry__ as graft
from dfu3d_tpu.data.dataset import PointBatch as JPointBatch
from dfu3d_tpu.parallel import make_mesh, replicate, shard_batch
from dfu3d_tpu.train.optimization import build_optimizer as j_build_optimizer
from dfu3d_tpu.train.train_state import create_train_state as j_create_train_state
from dfu3d_tpu.train.train_state import make_train_step as j_make_train_step
from dfu3d_tpu_torch import zoo
from dfu3d_tpu_torch.convert import params_from_jax
from dfu3d_tpu_torch.data.batch import synthetic_batch
from dfu3d_tpu_torch.flagship import flagship
from dfu3d_tpu_torch.models.depth_completion import ENet
from dfu3d_tpu_torch.parallel import all_gather_objects, distributed, init_distributed, mesh
from dfu3d_tpu_torch.train.optimization import build_optimizer
from dfu3d_tpu_torch.train.train_state import make_train_step
from dfu3d_tpu_torch.utils.config import CfgDict

import torch_port_dist_cases as cases
from test_torch_port_models import numpy_variables
from test_torch_port_threads import few_threads  # noqa: F401 (autouse)
from test_torch_port_train_slice import TOTAL_STEPS, _check, _gt, _shift_bn_biases, recording


def test_flagship_on_two_ranks_matches_jax_sharded_step():
    jcfg, _, jmodel = graft._flagship(dtype=jnp.float32, tiny=True)
    batch = synthetic_batch(4, 2048, 32, 12.0, seed=5)
    gt, valid = _gt(np.random.RandomState(30), 4, 32, (1, -11), (11, 11), 8)
    batch = batch._replace(gt_boxes=torch.from_numpy(gt), gt_valid=torch.from_numpy(valid))
    jbatch = JPointBatch(*(t.numpy() for t in batch))
    variables = _shift_bn_biases(numpy_variables(
        lambda: jmodel.init({"params": jax.random.PRNGKey(0)}, jbatch, train=False,
                            method=lambda m, b, train: m._features(b, train)),
        seed=32, gains={"vfe/pfn_0/Dense_0/kernel": 0.3,
                        "dense_head/fused_heads/out/kernel": 0.4}))
    tx, _ = j_build_optimizer(jcfg.OPTIMIZATION, TOTAL_STEPS)
    tx = recording(tx)
    state = j_create_train_state(jmodel, jbatch, tx)._replace(
        params=variables["params"], batch_stats=variables["batch_stats"])
    state = state._replace(opt_state=tx.init(state.params))
    jmesh = make_mesh(data=2, devices=jax.devices()[:2])
    new_state, jmetrics = jax.device_get(jax.jit(j_make_train_step(jmodel, tx))(
        replicate(jmesh, state), shard_batch(jmesh, jbatch)))

    cfg, _, model = flagship(tiny=True, device="cpu", train=True)
    params_from_jax(variables, model)
    start = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    ranks = cases.run_world(cases.builder("pillar", state_dict=start), [batch], 2,
                            keep_grads=True)
    cases.assert_ranks_equal(ranks)
    got = ranks[0]
    model.load_state_dict({k: torch.from_numpy(v) for k, v in got["state"].items()})
    raw = {k: torch.from_numpy(v) for k, v in got["grads"][0].items()}
    _check((got["metrics"][0], raw, model, jmetrics,
            params_from_jax({"params": new_state.opt_state["grads"]}),
            params_from_jax({"batch_stats": new_state.batch_stats}),
            params_from_jax({"batch_stats": variables["batch_stats"]})))
    want = params_from_jax({"params": new_state.params})
    jgrads = params_from_jax({"params": new_state.opt_state["grads"]})
    lr0 = build_optimizer(model.parameters(), cfg.OPTIMIZATION, TOTAL_STEPS).lr_fn(0)
    for k, w in want.items():
        w, g = w.numpy(), got["state"][k]
        sure = np.abs(raw[k].numpy() - jgrads[k].numpy()) <= 0.02 * np.abs(jgrads[k].numpy())
        tol = 1e-5 * (1 + np.abs(w).max())
        np.testing.assert_allclose(g[sure], w[sure], rtol=0, atol=tol, err_msg=k)
        assert (np.abs(g - w)[~sure] <= 2 * lr0 + tol).all(), k


class _FakeGroup:
    """dist.init_process_group recorded, not run."""

    def __init__(self, monkeypatch, cuda=True):
        self.calls, self.devices = [], []
        monkeypatch.setattr(dist, "init_process_group",
                            lambda backend, **kw: self.calls.append((backend, kw)))
        monkeypatch.setattr(dist, "get_rank", lambda: self.calls[-1][1]["rank"])
        monkeypatch.setattr(dist, "get_world_size", lambda: self.calls[-1][1]["world_size"])
        monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda)
        monkeypatch.setattr(torch.cuda, "set_device", self.devices.append)
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
                  "SLURM_NTASKS", "SLURM_PROCID", "SLURM_LOCALID", "SLURM_STEP_NODELIST"):
            monkeypatch.delenv(k, raising=False)


def test_init_distributed_from_torchrun(monkeypatch):
    group = _FakeGroup(monkeypatch)
    for k, v in {"RANK": "3", "WORLD_SIZE": "4", "LOCAL_RANK": "1",
                 "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "29500"}.items():
        monkeypatch.setenv(k, v)
    assert init_distributed("cuda") == (3, 4)
    ((backend, kw),) = group.calls
    assert backend == "nccl" and kw["init_method"] == "env://"
    assert (kw["rank"], kw["world_size"]) == (3, 4) and group.devices == [1]


def test_init_distributed_from_slurm(monkeypatch):
    group = _FakeGroup(monkeypatch)
    for k, v in {"SLURM_NTASKS": "8", "SLURM_PROCID": "5", "SLURM_LOCALID": "1",
                 "SLURM_STEP_NODELIST": "node[3-5],node7"}.items():
        monkeypatch.setenv(k, v)
    assert init_distributed("cpu") == (5, 8)
    ((backend, kw),) = group.calls
    assert backend == "gloo" and kw["init_method"] == "tcp://node3:12567"
    assert group.devices == []          # no card for a CPU rank
    monkeypatch.setenv("MASTER_PORT", "23456")
    init_distributed("cuda", backend="gloo")
    assert group.calls[-1][0] == "gloo" and group.calls[-1][1]["init_method"] == \
        "tcp://node3:23456" and group.devices == [1]


def test_init_distributed_one_process_and_no_card(monkeypatch):
    group = _FakeGroup(monkeypatch, cuda=False)
    assert init_distributed("cpu") == (0, 1) and group.calls == []
    assert all_gather_objects({"a": 1}) == [{"a": 1}]
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_distributed()              # the card by default, and there is none
    with pytest.raises(ValueError, match="nccl"):
        init_distributed("cpu", backend="nccl")
    assert group.calls == []
    assert distributed.slurm_head("gpu-a17") == "gpu" and distributed.slurm_head("n1,n2") == "n1"


def _second(device):
    return zoo.second_multihead(device=device, train=True)[-1]


@pytest.mark.parametrize("build", [lambda d: ENet(device=d).train(), _second],
                         ids=["ENet", "SECONDNet"])
def test_unaudited_models_raise_above_one_rank(monkeypatch, build):
    model = build("cpu")
    opt = build_optimizer(model.parameters(), CfgDict(
        {"OPTIMIZER": "adam", "LR": 1e-3}), 10)
    make_train_step(model, opt, device="cpu")          # one process: trains
    monkeypatch.setattr(mesh, "world", lambda: 2)
    with pytest.raises(NotImplementedError, match=type(model).__name__):
        make_train_step(model, opt, device="cpu")


def test_audited_models_hold_no_unaudited_module():
    assert mesh.unaudited(flagship(tiny=True, device="cpu", train=True)[-1]) == []
    assert mesh.unaudited(zoo.voxel_centerpoint(tiny=True, device="cpu", train=True)[-1]) == []
    assert mesh.unaudited(zoo.pointrcnn(device="cpu", train=True)[-1]) == []
