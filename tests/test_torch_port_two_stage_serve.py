"""Port parity: the two-stage voxel detectors (SECONDNetIoU, VoxelRCNN,
PVRCNN) serving against the JAX package, on the CPU, fp32 on both sides,
from the same numpy inputs and weights, at the test-scale configs of
tests/test_torch_port_two_stage.py: each detector's `predict`, keep masks
and labels exactly equal, boxes and scores within 1e-4.
tests/test_torch_port_two_stage_ckpt.py holds the checkpoint mappings and
the shipped configs.
"""
import jax
import numpy as np
import pytest
import torch

from test_model import make_batch
from test_torch_port_two_stage import MODELS, pair, port_batch
from test_torch_port_threads import few_threads  # noqa: F401 (autouse)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_predict_matches_jax(name):
    jmodel, variables, model, _ = pair(name)
    jbatch = make_batch(np.random.RandomState(4), b=2, n=512)
    want = jax.device_get(jax.jit(lambda v, b: jmodel.apply(
        v, b, method=lambda m, b: m.predict(b)))(variables, jbatch))
    with torch.no_grad():
        got = model.predict(port_batch(jbatch))
    wb, ws, wl, wv = want
    gb, gs, gl, gv = (a.numpy() for a in got)
    np.testing.assert_array_equal(gv, wv)
    assert wv.sum() >= 8
    np.testing.assert_array_equal(gl[gv], wl[wv])
    np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-4)
    np.testing.assert_allclose(gb[gv], wb[wv], rtol=0, atol=1e-4)
