"""Port parity: one whole train step of each DSVT CenterPoint (the pillar and
the voxel model of tests/test_torch_port_dsvt.py, their pooled set cap
binding for part of the second frame) against the JAX package's
`make_train_step`, on the CPU, fp32 on both sides, weights from numpy in
the flax layout with the BN biases +3 on both sides (as the voxel slice
tests), dsvt_pillar.yaml's adam_onecycle:

* the loss and its terms within 1e-5 relative, the grad_norm within 1e-5
  relative of the float64 norm of JAX's gradient leaves: JAX's own fp32
  grad_norm lies 1.1e-5 from that norm here (its sum of squares over the
  heads' 576-cell gradients rounds), the port's within 1e-6;
* every gradient leaf within 1e-4 of its largest entry (of 1e-4 of the
  whole gradient's largest entry where that is larger,
  test_torch_port_voxelnext_train.GRAD_FLOOR); a leaf whose gradient is 0 in
  exact arithmetic is held to its weight's largest entry: the CenterHead's
  conv biases before a train-mode BN, each position embedding's pos_fc1 bias
  before its train-mode BN, and each attention's key bias (a key bias adds
  the same logit to every key of a query, which the softmax takes out);
* the BN running statistics as in tests/test_torch_port_anchor.py.

And `profile_serve.dsvt_profile`'s spans and set shares on the CPU.
"""
import re
from pathlib import Path

import pytest

from dfu3d_tpu_torch.convert import params_from_jax
from dfu3d_tpu_torch.utils.config import CfgDict, cfg_from_yaml_file

from test_torch_port_dsvt import jax_batch, pair
from test_torch_port_threads import few_threads  # noqa: F401 (autouse)
from test_torch_port_train_slice import _shift_bn_biases
from test_torch_port_voxelnext_train import BIAS_BEFORE_BN, compare_train_step

TOOLS = Path(__file__).resolve().parents[1] / "tools"
ZERO_GRAD = re.compile(BIAS_BEFORE_BN.pattern + r"|_pos_fc1\.bias$|\.k\.bias$")


@pytest.mark.parametrize("voxel", [False, True], ids=["pillar", "voxel"])
def test_dsvt_train_step_matches_jax(voxel, monkeypatch):
    monkeypatch.chdir(TOOLS)   # the config names its base configs from there
    optim = cfg_from_yaml_file("cfgs/waymo_models/dsvt_pillar.yaml", CfgDict()).OPTIMIZATION
    jmodel, variables, model = pair(voxel, seed=2, train=True)
    variables = _shift_bn_biases(variables)
    params_from_jax(variables, model)
    metrics, raw = compare_train_step(jmodel, variables, model, jax_batch(7), optim,
                                      zero_biases=ZERO_GRAD, grad_norm_fp64=True)
    assert set(metrics) == {"loss", "rpn_loss", "hm_loss_head_0", "loc_loss_head_0",
                            "hm_loss_head_1", "loc_loss_head_1", "grad_norm"}
    # every layer of the trunk trains
    for k, g in raw.items():
        if k.startswith("backbone_3d.") and k.endswith((".q.weight", ".ffn2.weight")):
            assert float(g.abs().max()) > 0, k


def test_dsvt_profile_spans(monkeypatch):
    """`profile_serve.dsvt_profile` on the CPU (the device syncs stubbed):
    an eval step's and a train step's spans name the trunk's parts, and the
    set shares give each layer's share per frame, the second frame's below
    1 where the pooled cap binds."""
    import torch

    from dfu3d_tpu_torch import profile_serve
    from dfu3d_tpu_torch.train.train_state import (create_train_state, make_eval_step,
                                                   make_train_step)

    from test_torch_port_dsvt import port_batch

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.chdir(TOOLS)
    optim = cfg_from_yaml_file("cfgs/waymo_models/dsvt_pillar.yaml", CfgDict()).OPTIMIZATION
    batches = [port_batch(jax_batch(s)) for s in (3, 9)]
    _, _, model = pair(True)
    step = make_eval_step(model, (0.3, 0.5, 0.7), device="cpu", dtype=torch.float32)
    serve = profile_serve.dsvt_profile(model, lambda b: profile_serve._run(step, b), batches)
    spans = {"voxelize_vfe", "partition", "position_embeddings", "set_attention", "ffn_norms",
             "pools", "bev_scatter", "backbone_2d", "head", "decode", "decode.b1",
             "decode.keep_scan", "recall_iou", "recall_iou.b1", "rest", "step"}
    assert set(serve["phase_ms"]) == spans and serve["keep_scan"]
    shares = serve["set_shares"]
    assert len(shares) == 6 and all(len(row) == 2 and row[0] == 1.0 for row in shares)
    assert min(row[1] for row in shares) < 1.0
    assert serve["max_sets_per_frame"] == 16 and len(serve["voxels_per_frame"]) == 2
    _, _, model = pair(False, train=True)
    state = create_train_state(model, optim, 100)
    tstep = make_train_step(model, state.optimizer, device="cpu", dtype=torch.float32)
    train = profile_serve.dsvt_profile(model, lambda b: float(tstep(b)["loss"]), batches,
                                       state.optimizer)
    assert {"partition", "set_attention", "ffn_norms", "targets", "loss", "backward",
            "clip_optimizer"} <= set(train["phase_ms"]) and "pools" not in train["phase_ms"]
    assert len(train["set_shares"]) == 4 and train["keep_scan"] == []
