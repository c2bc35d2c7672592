"""Port parity: the PartA2 detector (PartA2Net) against the JAX package, on
the CPU, fp32 on both sides, from the same numpy inputs and weights, at
tests/test_parta2.py's test-scale config (SparseUNet 8-16, POOL_SIZE 8,
32 samples per RoI):

* a served request (`predict`) of PartA2 and of PartA2-free (DISABLE_PART,
  SEG_MASK_SCORE_THRESH 0, the voxel centres in the part stream): keep
  masks and labels exactly equal, boxes and scores within 1e-4;
* one train step against JAX's `make_train_step` (the checks of
  tests/test_torch_port_two_stage_train.py: sampled RoIs equal, metrics
  within 1e-5 relative, every gradient leaf within 1e-4 of its largest
  entry and nonzero in the reg branch, the parameters and BN statistics
  after the step);
* the reference mapping against the JAX package's `parta2_head_mapping`
  (spconv 2.x 5-D weights through `t_spconv_dense` and
  `params_from_jax`'s 5-D case), a save / load round trip;
* tools.train and tools.test on the shipped PartA2.yaml (its widths, the
  range cut to 25.6 m) with their B1 and B2 calls, and the span profile
  (the UNet decoder, the part head, the RoI-aware pools, the part losses).
"""
import jax
import numpy as np
import pytest
import torch

from dfu3d_tpu.train import torch_convert as jtc
from dfu3d_tpu_torch.train import torch_convert

from test_model import make_batch
from test_parta2 import pa2_cfg, pa2_grid
from test_torch_port_two_stage import build_pair, port_batch
from test_torch_port_two_stage import few_threads  # noqa: F401 (autouse)
from test_torch_port_two_stage_ckpt import check_reference_mapping
from test_torch_port_two_stage_cli import check_tools_train_and_test, check_two_stage_spans
from test_torch_port_two_stage_train import check_model_train_step


def free_cfg():
    """PartA2_free.yaml's changes at test scale: DISABLE_PART with threshold
    0 (the point head's REG_FC is not read, as in the JAX package)."""
    cfg = pa2_cfg()
    cfg["POINT_HEAD"] = {**cfg["POINT_HEAD"], "REG_FC": [32], "CLASS_AGNOSTIC": False}
    cfg["ROI_HEAD"] = {**cfg["ROI_HEAD"], "DISABLE_PART": True, "SEG_MASK_SCORE_THRESH": 0.0}
    return cfg


@pytest.mark.parametrize("name", ["parta2", "parta2_free"])
def test_predict_matches_jax(name):
    jmodel, variables, model, _ = build_pair(pa2_cfg() if name == "parta2" else free_cfg(),
                                             pa2_grid())
    assert model.disable_part == (name == "parta2_free")
    jbatch = make_batch(np.random.RandomState(4), b=2, n=512)
    want = jax.device_get(jax.jit(lambda v, b: jmodel.apply(
        v, b, method=lambda m, b: m.predict(b)))(variables, jbatch))
    with torch.no_grad():
        got = model.predict(port_batch(jbatch))
    wb, ws, wl, wv = want
    gb, gs, gl, gv = (a.numpy() for a in got)
    np.testing.assert_array_equal(gv, wv)
    assert wv.sum(1).min() >= 2
    np.testing.assert_array_equal(gl[gv], wl[wv])
    np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-4)
    np.testing.assert_allclose(gb[gv], wb[wv], rtol=0, atol=1e-4)


def test_train_step_matches_jax(monkeypatch):
    """JAX draws 3 dropout masks (SHARED_FC's one, CLS_FC's and REG_FC's)."""
    jmodel, variables, model, _ = build_pair(pa2_cfg(), pa2_grid(), seed=2, train=True)
    check_model_train_step(jmodel, variables, model, ("roi_head.reg_fc.",), 3, monkeypatch)


def test_reference_mapping_matches_jax(tmp_path):
    """JAX's parta2_head_mapping with the anchor head's: the RPN and the RoI
    head load as JAX loads them; the UNet and the part head stay
    unmatched."""
    _, variables, model, _ = build_pair(pa2_cfg(), pa2_grid(), seed=3)
    j_mapping = {**jtc.anchor_head_mapping(),
                 **jtc.parta2_head_mapping(shared_fc=(32, 32), cls_fc=(16,), reg_fc=(16,),
                                           num_features=32)}
    own = model.state_dict()
    assert sum(own[k].dim() == 5 for k in model.reference_mapping() if k in own) == 4
    check_reference_mapping(variables, model, j_mapping,
                            ("unet.", "seg_mlp.", "seg_out.", "part_out."), pa2_cfg(),
                            pa2_grid(), tmp_path)
    assert torch_convert.is_reference_state({"roi_head.conv_part.0.0.0.weight": None})


def test_tools_train_and_test_parta2(tmp_path, monkeypatch):
    """test_tools_train_and_test_voxel_rcnn's run on PartA2.yaml, with 16
    sampled RoIs per frame in place of 128 (the RoI head keeps its 12³ grid
    and widths): B2 12 + 11 times per train step, 12 per test batch."""
    check_tools_train_and_test(tmp_path, monkeypatch, "PartA2.yaml", 12,
                               ("MODEL.ROI_HEAD.TARGET_CONFIG.ROI_PER_IMAGE", "16"))


def test_two_stage_spans(monkeypatch):
    _, _, model, _ = build_pair(pa2_cfg(), pa2_grid())
    check_two_stage_spans(model, monkeypatch,
                          ("sparse_convs.unet_decoder", "sparse_convs.unet_decoder.b2",
                           "part_head"), ("part_loss",))
