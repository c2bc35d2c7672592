"""Port parity: VoxelNeXt's `predict` against the JAX package, on the CPU,
fp32 on both sides, at tests/test_torch_port_voxelnext.py's config, grid
and weights (`pair`), with the IoU branch's rectified scores and with the
double-flip TTA: keep masks and labels equal, boxes and scores within 1e-4.
"""
import jax
import numpy as np
import pytest
import torch

from test_model import make_batch
from test_torch_port_threads import few_threads  # noqa: F401 (autouse)
from test_torch_port_voxelnext import pair, port_batch


@pytest.mark.parametrize("variant", ["iou", "double_flip"])
def test_predict_matches_jax(variant):
    """The decode end to end from points: top-K over (class, voxel) with
    jax.lax.top_k's order, each selection from its class's group branch,
    the IoU branch's score^(1-w) · iou^w rectification, or the four flipped
    copies merged; then rotated NMS (B1's twin). Keep masks and labels
    equal, boxes and scores within 1e-4."""
    jmodel, variables, model = pair(variant, seed=4)
    jbatch = make_batch(np.random.RandomState(3), b=2, n=512)
    want = jax.device_get(jax.jit(
        lambda v, b: jmodel.apply(v, b, method=lambda m, bb: m.predict(bb)))(variables, jbatch))
    with torch.no_grad():
        got = model.eval().predict(port_batch(jbatch))
    boxes, scores, labels, keep = (x.numpy() for x in got)
    np.testing.assert_array_equal(keep, np.asarray(want[3]))
    np.testing.assert_array_equal(labels, np.asarray(want[2]))
    np.testing.assert_allclose(boxes, np.asarray(want[0]), atol=1e-4)
    np.testing.assert_allclose(scores, np.asarray(want[1]), atol=1e-4)
    assert keep.sum() > 4 and np.isfinite(boxes).all()
    assert len(np.unique(labels[keep])) > 1
