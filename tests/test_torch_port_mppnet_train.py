"""Port parity: one whole MPPNet train step (4 frames, the test-scale config
of tests/test_torch_port_mppnet.py) against the JAX package's
`make_train_step`, on the CPU, fp32 on both sides, mppnet_4frames.yaml's
adam_onecycle, the proposal target layer's uniforms handed over from JAX's
key (`jax_draws`), gt appended from the port's own first-stage boxes
(`zoo.proposal_gt`, 4 per frame) so that every frame has RoIs over
REG_FG_THRESH and the head's reg branch trains:

* the sampled RoIs exactly equal;
* the loss and its terms within 1e-5 relative, the grad_norm within 1e-5
  relative of the float64 norm of JAX's gradient leaves;
* every gradient leaf within 1e-4 of its largest entry (of 1e-4 of the
  whole gradient's largest entry where that is larger); the biases in front
  of a train-mode BN (gradient 0 in exact arithmetic), the attentions' key
  biases (a key bias adds the same logit to every key of a query) and the
  mixers' out biases (one shift of every channel of a lattice cell, which
  the LayerNorm over the channels takes out) held to their weights' largest
  entry; the head's reg branch nonzero;
* the BN running statistics as in tests/test_torch_port_anchor.py.

And `profile_serve.mppnet_profile`'s spans on the CPU: an eval step, a bank
step of the E2E model and a train step.
"""
import re

import numpy as np
import torch

from dfu3d_tpu.data.dataset import PointBatch as JPointBatch
from dfu3d_tpu_torch import zoo
from dfu3d_tpu_torch.models import roi_head as proi
from dfu3d_tpu_torch.utils.config import CfgDict, cfg_from_yaml_file

from test_torch_port_mppnet import detector_pair, jax_batch, port_batch
from test_torch_port_pointrcnn_train import CaptureTargets, capture_port_targets, jax_draws
from test_torch_port_threads import few_threads  # noqa: F401 (autouse)
from test_torch_port_voxelnext_train import BIAS_BEFORE_BN, compare_train_step

ZERO_GRAD = re.compile(BIAS_BEFORE_BN.pattern + r"|\.k\.bias$|mixer_[xyz]\.fc2\.bias$")
OPTIM = cfg_from_yaml_file(zoo.CFGS / "waymo_models/mppnet_4frames.yaml", CfgDict()).OPTIMIZATION


def test_mppnet_train_step_matches_jax(monkeypatch):
    jmodel, variables, model = detector_pair("MPPNet", seed=2, train=True)
    batch = zoo.proposal_gt(model, port_batch(jax_batch(7)), count=4)
    jbatch = JPointBatch(*(np.asarray(x) for x in batch))
    capture = CaptureTargets(monkeypatch)
    draws = {}

    def handed_over(generator, shape, device):
        if "draws" not in draws:
            draws["draws"] = jax_draws(capture.seen["key"], shape[0], shape[2])
        return draws["draws"]

    monkeypatch.setattr(proi, "draw_roi_uniforms", handed_over)
    ported = capture_port_targets(monkeypatch)
    metrics, raw = compare_train_step(jmodel, variables, model, jbatch, OPTIM,
                                      zero_biases=ZERO_GRAD, grad_norm_fp64=True)
    assert (capture.seen["reg_valid_mask"].sum(1) > 0).all()
    np.testing.assert_array_equal(ported["sampled_idx"].numpy(), capture.seen["sampled_idx"])
    assert set(metrics) == {"loss", "rpn_loss_cls", "rpn_loss_loc", "rpn_loss_dir", "rpn_loss",
                            "rcnn_cls_loss", "rcnn_reg_loss", "grad_norm"}
    for branch in ("jointembed.fc3.", "bbox_embed0.fc3.", "seqboxembed.fc_ce2.",
                   "layer0.cross_attn1.q.", "Dense_3."):
        leaves = [k for k in raw if k.startswith("roi_head." + branch)]
        assert leaves and all(float(raw[k].abs().max()) > 0 for k in leaves), branch


def test_mppnet_profile_spans(monkeypatch):
    """`profile_serve.mppnet_profile` on the CPU (the device syncs stubbed):
    an eval step's spans name the first stage's and the head's parts with
    their B1 launches, a bank step adds the bank match, a train step the
    targets, losses, backward and optimizer; 8 frames in 4 groups leave
    frames 5-7 dead."""
    from dfu3d_tpu_torch import profile_serve
    from dfu3d_tpu_torch.models.mppnet import make_bank_eval_step
    from dfu3d_tpu_torch.train.train_state import (create_train_state, make_eval_step,
                                                   make_train_step)

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    batches = [port_batch(jax_batch(s)) for s in (3, 9)]
    _, _, model = detector_pair("MPPNet")
    step = make_eval_step(model, (0.3, 0.5, 0.7), device="cpu")
    serve = profile_serve.mppnet_profile(model, lambda b: profile_serve._run(step, b), batches)
    spans = {"voxelize_vfe", "tables", "trunk", "trunk.b2", "backbone_2d", "anchor_head",
             "proposals", "proposals.b1", "proposals.keep_scan", "trajectory",
             "trajectory.b1", "crops", "geometry_mlp", "proxy_pooling",
             "proxy_pooling.ball_query", "motion", "encoder", "heads", "refine", "recall_iou",
             "recall_iou.b1", "rest", "step"}
    assert spans <= set(serve["phase_ms"]) and serve["keep_scan"]
    assert serve["dead_frames"] == [] and serve["dead_frame_share_of_head"] == 0.0

    _, _, e2e = detector_pair("MPPNetE2E")
    bank_step = make_bank_eval_step(e2e, (0.3, 0.5, 0.7), device="cpu")
    bank = [e2e.empty_bank(2)]

    def run_bank(b):
        out, bank[0] = bank_step(b, bank[0])
        return out

    e2e_prof = profile_serve.mppnet_profile(e2e, run_bank, batches, fresh_frames=1)
    assert {"bank_match", "bank_match.b1"} <= set(e2e_prof["phase_ms"])

    _, _, model8 = detector_pair("MPPNet", frames=8, groups=4, train=True)
    state = create_train_state(model8, OPTIM, 100)
    tstep = make_train_step(model8, state.optimizer, device="cpu", dtype=torch.float32)
    batches8 = [port_batch(jax_batch(s, frames=8)) for s in (3, 9)]
    train = profile_serve.mppnet_profile(model8, lambda b: float(tstep(b)["loss"]), batches8,
                                         state.optimizer)
    assert {"group_fusion", "anchor_loss", "anchor_loss.anchor_targets", "roi_targets",
            "roi_targets.b1", "head_losses", "backward", "clip_optimizer"} <= set(
        train["phase_ms"])
    assert train["dead_frames"] == [5, 6, 7] and 0 < train["dead_frame_share_of_head"] < 1
    assert train["keep_scan"] == []
