"""Port parity: box geometry, the rotated-BEV overlap (plain twin of the CUDA
kernel), IoU and NMS against the JAX package, fp32 on both sides. The
kernel itself runs only on the card: tests/test_torch_port_kernels.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfu3d_tpu.core.geometry import boxes as jboxes
from dfu3d_tpu.core.geometry import iou as jiou
from dfu3d_tpu.core.geometry import nms as jnms
from dfu3d_tpu.core.geometry.iou_pallas import pairwise_overlap_bev_pallas
from dfu3d_tpu_torch.core.geometry import boxes, iou, iou_kernel, nms
from test_torch_port_kernels import near_miss_boxes


def _rand_boxes(rng, n, spread=3.0, far=0.0):
    b = np.zeros((n, 7), np.float32)
    b[:, 0:2] = rng.uniform(-spread, spread, (n, 2))
    b[:, 0] += far
    b[:, 2] = rng.uniform(-1, 1, n)
    b[:, 3:6] = rng.uniform(0.5, 4.0, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


class TestBoxes:
    @pytest.mark.parametrize("width", [7, 5])
    def test_corners_bev_match_jax(self, rng, width):
        b = _rand_boxes(rng, 64)
        if width == 5:
            b = b[:, [0, 1, 3, 4, 6]]
        want = np.asarray(jboxes.boxes_to_corners_bev(jnp.asarray(b)))
        got = boxes.boxes_to_corners_bev(_t(b)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)

    def test_limit_period_and_rotation_match_jax(self, rng):
        ang = rng.uniform(-10, 10, 100).astype(np.float32)
        np.testing.assert_allclose(boxes.limit_period(_t(ang)).numpy(),
                                   np.asarray(jboxes.limit_period(jnp.asarray(ang))), atol=1e-5)
        pts = rng.normal(0, 5, (3, 20, 5)).astype(np.float32)
        rot = rng.uniform(-3, 3, 3).astype(np.float32)
        np.testing.assert_allclose(
            boxes.rotate_points_along_z(_t(pts), _t(rot)).numpy(),
            np.asarray(jboxes.rotate_points_along_z(jnp.asarray(pts), jnp.asarray(rot))),
            atol=1e-5)


class TestOverlap:
    @pytest.mark.parametrize("far", [0.0, 60.0])
    def test_plain_matches_xla(self, rng, far):
        a, b = _rand_boxes(rng, 150, far=far), _rand_boxes(rng, 70, far=far)
        want = np.asarray(jiou.pairwise_overlap_bev(jnp.asarray(a), jnp.asarray(b)))
        got = iou.pairwise_overlap_bev(_t(a), _t(b)).numpy()
        assert got.shape == (150, 70)
        assert (want > 0).mean() > 0.2  # the boxes really overlap
        np.testing.assert_allclose(got, want, atol=1e-4)

    def test_plain_matches_pallas_interpret(self, rng):
        """The Pallas kernel centres on one midpoint per 128 × 128 tile, the
        port per pair, hence the looser tolerance (as tests/test_iou_pallas.py)."""
        a, b = _rand_boxes(rng, 150), _rand_boxes(rng, 70)
        want = np.asarray(pairwise_overlap_bev_pallas(jnp.asarray(a), jnp.asarray(b),
                                                      interpret=True))
        got = iou.pairwise_overlap_bev(_t(a), _t(b)).numpy()
        np.testing.assert_allclose(got, want, atol=2e-3)

    @pytest.mark.parametrize("far", [0.0, 60.0])
    def test_identical_boxes_diagonal_is_area(self, rng, far):
        a = _rand_boxes(rng, 32, far=far)
        got = iou.pairwise_overlap_bev(_t(a), _t(a)).numpy()
        np.testing.assert_allclose(np.diag(got), a[:, 3] * a[:, 4], rtol=1e-4)

    def test_batched_equals_single(self, rng):
        a = np.stack([_rand_boxes(rng, 40) for _ in range(3)])
        b = np.stack([_rand_boxes(rng, 25) for _ in range(3)])
        got = iou.pairwise_overlap_bev(_t(a), _t(b)).numpy()
        for g in range(3):
            want = np.asarray(jiou.pairwise_overlap_bev(jnp.asarray(a[g]), jnp.asarray(b[g])))
            np.testing.assert_allclose(got[g], want, atol=1e-4)

    def test_chunked_plain_equals_unchunked(self, rng):
        ca = boxes.boxes_to_corners_bev(_t(np.stack([_rand_boxes(rng, 30) for _ in range(4)])))
        cb = boxes.boxes_to_corners_bev(_t(np.stack([_rand_boxes(rng, 20) for _ in range(4)])))
        whole = iou_kernel.overlap_bev_plain(ca, cb)
        for chunk in (100, 700, 1500):  # row chunks, and several g per chunk
            torch.testing.assert_close(iou_kernel.overlap_bev_plain(ca, cb, chunk), whole,
                                       rtol=0, atol=0)

    def test_empty_and_argument_checks(self):
        empty = torch.zeros((2, 0, 4, 2))
        full = torch.zeros((2, 5, 4, 2))
        assert iou_kernel.overlap_bev(empty, full).shape == (2, 0, 5)
        assert iou_kernel.overlap_bev(full, empty).shape == (2, 5, 0)
        with pytest.raises(TypeError):
            iou_kernel.overlap_bev(full.double(), full.double())
        with pytest.raises(ValueError):
            iou_kernel.overlap_bev(full.transpose(0, 1).contiguous().transpose(0, 1), full)
        with pytest.raises(ValueError):
            iou_kernel.overlap_bev(full, torch.zeros((3, 5, 4, 2)))

    def test_iou_bev_and_iou3d_match_jax(self, rng):
        a, b = _rand_boxes(rng, 60), _rand_boxes(rng, 45)
        for port_fn, jax_fn in ((iou.pairwise_iou_bev, jiou.pairwise_iou_bev),
                                (iou.pairwise_iou3d, jiou.pairwise_iou3d)):
            want = np.asarray(jax_fn(jnp.asarray(a), jnp.asarray(b)))
            np.testing.assert_allclose(port_fn(_t(a), _t(b)).numpy(), want, atol=1e-5)
        a5 = a[:, [0, 1, 3, 4, 6]]
        np.testing.assert_allclose(
            iou.pairwise_iou_bev(_t(a5), _t(a5)).numpy(),
            np.asarray(jiou.pairwise_iou_bev(jnp.asarray(a5), jnp.asarray(a5))), atol=1e-5)


def _cull_case(rng, case):
    """(a, b) (N, 7) / (M, 7) fp32 numpy boxes for the cull tests."""
    if case in ("random_0m", "random_60m"):
        far = 60.0 if case == "random_60m" else 0.0
        return _rand_boxes(rng, 150, spread=20.0, far=far), _rand_boxes(rng, 70, spread=20.0, far=far)
    if case in ("near_miss_0m", "near_miss_60m"):
        return near_miss_boxes(rng, 100, far=60.0 if case == "near_miss_60m" else 0.0)
    if case == "thin_shallow":  # 20 m x 0.1 m at headings within 0.05 rad of 0
        return near_miss_boxes(rng, 100, footprint=(20.0, 0.1), heading=0.05)
    # zero_size: the gt padding's all-zero rows and zero-size boxes elsewhere
    a, b = _rand_boxes(rng, 80, spread=20.0), _rand_boxes(rng, 60, spread=20.0)
    a[::4] = 0.0
    b[::3] = 0.0
    a[1::4, 3:5] = 0.0
    b[1::3, 3:5] = 0.0
    return a, b


def _overlaps_and_cull(a, b):
    """(culled, plain, JAX) as (N, M) numpy arrays."""
    ca, cb = boxes.boxes_to_corners_bev(_t(a))[None], boxes.boxes_to_corners_bev(_t(b))[None]
    culled = iou_kernel.overlap_bev_cull_plain(ca, cb)[0].numpy()
    plain = iou_kernel.overlap_bev_plain(ca, cb)[0].numpy()
    ref = np.asarray(jiou.pairwise_overlap_bev(jnp.asarray(a), jnp.asarray(b)))
    return culled, plain, ref


class TestCull:
    """The kernel's cull predicate (plain twin `overlap_bev_cull_plain`): a
    culled pair must be exactly 0 in the plain twin and in JAX's
    pairwise_overlap_bev, and no pair that overlaps may be culled."""

    @pytest.mark.parametrize("case", ["random_0m", "random_60m", "near_miss_0m",
                                      "near_miss_60m", "thin_shallow", "zero_size"])
    def test_culled_pairs_are_exactly_zero(self, rng, case):
        a, b = _cull_case(rng, case)
        culled, plain, ref = _overlaps_and_cull(a, b)
        assert culled.any() and not culled.all()
        assert (plain[culled] == 0).all() and (ref[culled] == 0).all()
        assert not culled[(plain > 0) | (ref > 0)].any()
        if case.startswith("near_miss") or case == "thin_shallow":
            # pair (i, i) is apart by 1.001 margins and culled, (i, n + i) by 0.999 and kept
            n = len(a)
            assert culled[np.arange(n), np.arange(n)].all()
            assert not culled[np.arange(n), n + np.arange(n)].any()
        if case == "zero_size":
            # against a zero-size B every edge of A lies "inside" (all its
            # half-planes are the tolerance): overlap(A, B) is A's area at
            # any distance, in JAX as in the twin, so such pairs stay
            point_b = (b[:, 3] == 0) & (b[:, 4] == 0)
            quad_a = (a[:, 3] > 0) & (a[:, 4] > 0)
            np.testing.assert_allclose(ref[np.ix_(quad_a, point_b)],
                                       np.broadcast_to((a[quad_a, 3] * a[quad_a, 4])[:, None],
                                                       (quad_a.sum(), point_b.sum())),
                                       rtol=1e-4)
            assert not culled[np.ix_(quad_a, point_b)].any()
            point_a = (a[:, 3] == 0) & (a[:, 4] == 0)
            assert culled[point_a].any()

    def test_non_finite_corner_is_never_culled(self, rng):
        a, b = _rand_boxes(rng, 40, spread=20.0), _rand_boxes(rng, 30, spread=20.0)
        ca, cb = boxes.boxes_to_corners_bev(_t(a))[None], boxes.boxes_to_corners_bev(_t(b))[None]
        ca[0, 0, 1, 0] = float("nan")
        ca[0, 1, 2, 1] = float("inf")
        cb[0, 2, 0, 0] = -float("inf")
        cb[0, 3] = float("nan")
        culled = iou_kernel.overlap_bev_cull_plain(ca, cb)[0]
        assert not culled[:2].any() and not culled[:, 2:4].any()
        assert culled[2:, 4:].any()

    @pytest.mark.parametrize("kind", ["bow_tie", "clockwise", "sliver", "beyond_limit"])
    def test_malformed_box_is_never_culled(self, rng, kind):
        """Boxes whose half-planes need not bound them (corner order crossed
        or reversed, an edge under 1 cm) or whose side distances carry more
        fp32 error than the margin allows (beyond COORD_LIMIT) have kind 0."""
        a, b = _rand_boxes(rng, 40, spread=20.0), _rand_boxes(rng, 30, spread=20.0)
        if kind == "sliver":
            a[::2, 4] = 0.005
            b[::2, 4] = 0.005
        if kind == "beyond_limit":
            a[::2, 0] += 2000.0
            b[::2, 0] += 2000.0
        ca, cb = boxes.boxes_to_corners_bev(_t(a))[None], boxes.boxes_to_corners_bev(_t(b))[None]
        if kind == "bow_tie":
            ca[0, ::2] = ca[0, ::2][:, [0, 2, 1, 3]]
            cb[0, ::2] = cb[0, ::2][:, [0, 2, 1, 3]]
        if kind == "clockwise":
            ca[0, ::2] = ca[0, ::2].flip(1)
            cb[0, ::2] = cb[0, ::2].flip(1)
        assert (iou_kernel._box_kind(ca)[0, ::2] == 0).all()
        assert (iou_kernel._box_kind(ca)[0, 1::2] == iou_kernel.QUAD).all()
        culled = iou_kernel.overlap_bev_cull_plain(ca, cb)[0]
        assert not culled[::2].any() and not culled[:, ::2].any()
        assert culled[1::2, 1::2].any()
        plain = iou_kernel.overlap_bev_plain(ca, cb)[0]
        assert (plain[culled] == 0).all()


class TestNMS:
    def test_scan_equals_sequential_oracle(self, rng):
        """Same IoU matrices → keep sets identical to JAX's sequential oracle."""
        g, n = 6, 80
        mats = rng.uniform(0, 1, (g, n, n)).astype(np.float32) ** 4
        valid = rng.uniform(0, 1, (g, n)) > 0.1
        want = np.stack([np.asarray(jnms._suppression_scan_reference(
            jnp.asarray(mats[i]), jnp.asarray(valid[i]), 0.3)) for i in range(g)])
        got = nms._suppression_scan(_t(mats), _t(valid), 0.3)[0].numpy()
        ref = nms._suppression_scan_reference(_t(mats), _t(valid), 0.3).numpy()
        np.testing.assert_array_equal(ref, want)
        np.testing.assert_array_equal(got, want)
        assert 0 < want.sum() < valid.sum()

    def test_strict_threshold(self):
        mat = torch.tensor([[1.0, 0.5], [0.5, 1.0]])[None]
        valid = torch.ones((1, 2), dtype=torch.bool)
        assert nms._suppression_scan(mat, valid, 0.5)[0].all()     # iou == thresh keeps
        assert not nms._suppression_scan(mat, valid, 0.49)[0][0, 1]

    def test_nms_bev_matches_jax(self, rng):
        g, n = 4, 200
        bx = np.stack([_rand_boxes(rng, n, spread=4.0) for _ in range(g)])
        sc = np.stack([rng.permutation(n) for _ in range(g)]).astype(np.float32) / n
        valid = rng.uniform(0, 1, (g, n)) > 0.2
        run = jax.vmap(lambda b, s, v: jnms.nms_bev(b, s, 0.3, pre_max=150, post_max=120,
                                                    valid=v))
        want_idx, want_keep = (np.asarray(a) for a in run(
            jnp.asarray(bx), jnp.asarray(sc), jnp.asarray(valid)))
        got_idx, got_keep = nms.nms_bev(_t(bx), _t(sc), 0.3, pre_max=150, post_max=120,
                                        valid=_t(valid))
        np.testing.assert_array_equal(got_keep.numpy(), want_keep)
        np.testing.assert_array_equal(got_idx.numpy(), want_idx)
        assert 0 < want_keep.sum() < g * 120

    def test_top_k_puts_lower_index_first_on_ties(self):
        vals, idx = nms.top_k(torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]]), 4)
        assert idx.tolist() == [[1, 2, 4, 3]]
        jv, ji = jax.lax.top_k(jnp.asarray([1.0, 3.0, 3.0, 2.0, 3.0]), 4)
        assert np.asarray(ji).tolist() == idx[0].tolist()

