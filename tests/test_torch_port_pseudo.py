"""Port parity: pipeline 2's pseudo-box factory against the JAX package, fp32 on
both sides and on the CPU: the device programs of `pseudo.ops`, the whole
`PseudoBoxFactory.process_frame` on `make_scene` frames, the synthetic
scenes and their KITTI writer, the SEEM adapter, and the PNG reader that
replaces PIL in the port.

The RANSAC triples are drawn by JAX (`jax.random.categorical` over the valid
points, as its fit_ground_plane draws them) and injected into the port.
Tolerances: masks, labels, cluster selections, counts and names exact;
planes within 1e-5; corners and boxes within 1e-4; the fused cloud equal.
"""
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dfu3d_tpu.pseudo import factory as jfactory
from dfu3d_tpu.pseudo import ops as jops
from dfu3d_tpu.pseudo import seem_adapter as jseem
from dfu3d_tpu.pseudo import synthetic as jsynth
from dfu3d_tpu_torch.data import kitti_io, kitti_synthetic
from dfu3d_tpu_torch.pseudo import factory as tfactory
from dfu3d_tpu_torch.pseudo import ops as tops
from dfu3d_tpu_torch.pseudo import seem_adapter as tseem
from dfu3d_tpu_torch.pseudo import synthetic as tsynth

PLANE_TOL = 1e-5
BOX_TOL = 1e-4
# rectangle_search may take the other of two θ whose costs JAX itself finds
# within this relative gap (fp32 sums in another order can swap them)
THETA_GAP = 1e-5


def t(a):
    return torch.from_numpy(np.array(a))


def jax_triples(key, valid, iters=128):
    """The (iters, 3) point indices fit_ground_plane draws from `key`."""
    logits = jnp.where(jnp.asarray(valid), 0.0, -1e9)
    keys = jax.random.split(key, 3)
    return np.array(jnp.stack([jax.random.categorical(k, logits, shape=(iters,))
                               for k in keys], axis=-1))


def frame_triples(factory_key, n_lidar):
    """The JAX factory's triples for its next frame: (new factory key, triples)."""
    key, sub = jax.random.split(factory_key)
    valid = np.zeros(tfactory.LIDAR_CAP, bool)
    valid[:min(n_lidar, tfactory.LIDAR_CAP)] = True
    return key, jax_triples(sub, valid)


def boundary_points(rng, cx, cy, length, width, theta, n):
    """n points on a rectangle's outline (a Car's L-shaped returns)."""
    s = rng.uniform(0, 1, n)
    side = rng.randint(0, 4, n)
    xs = np.where(side == 0, -length / 2 + s * length, np.where(
        side == 1, length / 2, np.where(side == 2, -length / 2 + s * length, -length / 2)))
    ys = np.where(side == 0, -width / 2, np.where(
        side == 1, -width / 2 + s * width, np.where(side == 2, width / 2, -width / 2 + s * width)))
    c, sn = np.cos(theta), np.sin(theta)
    return np.stack([xs * c - ys * sn + cx, xs * sn + ys * c + cy,
                     rng.uniform(-1.6, 0.0, n)], axis=1).astype(np.float32)


def padded(pts, cap):
    out = np.zeros((cap, 3), np.float32)
    out[:len(pts)] = pts[:cap, :3]
    valid = np.zeros(cap, bool)
    valid[:min(len(pts), cap)] = True
    return out, valid


def instances(seed, k=4, cap=128):
    """(K, cap, 3) LiDAR and pseudo points of K boxes with noise and an
    isolated outlier each, and their masks."""
    rng = np.random.RandomState(seed)
    ol, olv, op, opv = [], [], [], []
    for _ in range(k):
        box = (rng.uniform(5, 30), rng.uniform(-8, 8), rng.uniform(3.5, 5), rng.uniform(1.5, 2),
               rng.uniform(-np.pi, np.pi))
        lid = boundary_points(rng, *box, n=rng.randint(40, 100))
        pse = lid[rng.randint(0, len(lid), rng.randint(30, 90))] + rng.normal(0, 0.03, (1, 3))
        pse = np.concatenate([pse.astype(np.float32), [[80.0, 40.0, 0.0]]], 0)
        lid = np.concatenate([lid, [[-30.0, -30.0, 0.0]]], 0)
        for src, pts, val in ((lid, ol, olv), (pse, op, opv)):
            p, v = padded(src, cap)
            pts.append(p)
            val.append(v)
    return tuple(np.stack(a) for a in (ol, olv, op, opv))


# --- PNG ------------------------------------------------------------------

def png_bytes(pixels, colour, filters):
    """An 8-bit PNG whose rows use filter types `filters` (cycled), encoded
    here by the PNG specification's section 9."""
    h, w = pixels.shape[:2]
    bpp = pixels.shape[2] if pixels.ndim == 3 else 1
    rows = pixels.reshape(h, w * bpp).astype(np.int32)
    raw = bytearray()
    prev = np.zeros(w * bpp, np.int32)
    for r in range(h):
        kind = filters[r % len(filters)]
        cur = rows[r]
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        up_left = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - up_left
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - up_left)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, up_left))
        raw.append(kind)
        raw += ((cur - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = cur

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0)
    return (kitti_io.PNG_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


def png_filters(path):
    """The filter type of every row of a non-interlaced 8-bit PNG."""
    data = path.read_bytes()
    w, h, _, colour = struct.unpack(">IIBB", data[16:26])
    bpp = {0: 1, 2: 3, 6: 4}[colour]
    pos, idat = 8, b""
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w * bpp + 1)
    return set(raw[:, 0].tolist())


def sample_image(mode, h=61, w=83, seed=0):
    """A gradient with noise and flat patches: PIL's adaptive filter choice
    then differs from row to row."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([xx * 3 + yy, yy * 5 - xx, (xx * yy) // 7, xx ^ yy], -1) & 0xFF
    base[::5] = rng.randint(0, 256, base[::5].shape)
    base[10:20, 10:40] = 77
    arr = base.astype(np.uint8)
    return {"L": arr[..., 0], "RGB": arr[..., :3], "RGBA": arr}[mode]


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_read_png_matches_pil_on_pil_files(tmp_path, mode):
    """PIL's adaptive filter choice; with optimize=True it also tries
    Average, so these files use all five filter types."""
    seen = set()
    for seed in range(3):
        for optimize in (False, True):
            path = tmp_path / f"{mode}{seed}{optimize}.png"
            Image.fromarray(sample_image(mode, seed=seed), mode).save(path, optimize=optimize)
            seen |= png_filters(path)
            want = np.asarray(Image.open(path).convert("RGB"))
            native = kitti_io.read_png(path)
            assert native.dtype == np.uint8 and native.shape == want.shape
            np.testing.assert_array_equal(native, want)
            np.testing.assert_array_equal(kitti_io.read_png(path, use_native=False), native)
    assert seen == {0, 1, 2, 3, 4}, f"PIL wrote only filter types {seen}"


@pytest.mark.parametrize("colour,mode", [(0, "L"), (2, "RGB"), (6, "RGBA")])
def test_read_png_every_filter_type(tmp_path, colour, mode):
    pixels = sample_image(mode, seed=4)
    path = tmp_path / "f.png"
    path.write_bytes(png_bytes(pixels, colour, filters=(0, 1, 2, 3, 4, 4, 3, 1)))
    assert png_filters(path) == {0, 1, 2, 3, 4}
    want = np.asarray(Image.open(path).convert("RGB"))
    np.testing.assert_array_equal(kitti_io.read_png(path), want)
    np.testing.assert_array_equal(kitti_io.read_png(path, use_native=False), want)


@pytest.mark.parametrize("kind", ["16bit", "palette", "gray_alpha", "interlaced", "bad_filter"])
def test_read_png_raises_on_other_pngs(tmp_path, kind):
    path = tmp_path / f"{kind}.png"
    img = sample_image("RGB")
    if kind == "16bit":
        Image.fromarray(img[..., 0].astype(np.uint16) * 200).save(path)
    elif kind == "palette":
        Image.fromarray(img, "RGB").convert("P").save(path)
    elif kind == "gray_alpha":
        Image.fromarray(img[..., :2].copy(), "LA").save(path)
    else:
        data = bytearray(png_bytes(img, 2, filters=(1,)))
        if kind == "interlaced":
            data[28] = 1
            data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])) & 0xFFFFFFFF)
        else:   # a filter byte of 7
            data = bytearray(png_bytes(img, 2, filters=(7,)))
        path.write_bytes(bytes(data))
    for native in (True, False):
        with pytest.raises(ValueError):
            kitti_io.read_png(path, use_native=native)


def test_png_unfilter_build_failure_raises(monkeypatch, tmp_path):
    broken = tmp_path / "png_unfilter.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(kitti_io, "PNG_UNFILTER_SOURCE", broken)
    monkeypatch.setattr(kitti_io, "PNG_BUILD_DIR", tmp_path / "build")
    path = tmp_path / "a.png"
    kitti_synthetic.write_png_rgb(path, sample_image("RGB"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        kitti_io.read_png(path)
    np.testing.assert_array_equal(kitti_io.read_png(path, use_native=False), sample_image("RGB"))


@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_png_writers_round_trip_through_pil(tmp_path, mode):
    img = sample_image(mode, seed=2)
    path = tmp_path / "w.png"
    if mode == "RGB":
        kitti_synthetic.write_png_rgb(path, img)
        want = img
    else:
        kitti_synthetic.write_png(path, img)
        want = np.repeat(img[..., None], 3, axis=2)
    np.testing.assert_array_equal(np.asarray(Image.open(path).convert("RGB")), want)
    np.testing.assert_array_equal(kitti_io.read_png(path), want)


# --- SEEM adapter ------------------------------------------------------------

def seg_result(mod, h=40, w=60):
    masks = np.zeros((3, h, w), bool)
    masks[0, 5:15, 10:30] = True
    masks[1, 20:35, 40:55] = True
    return mod.SegmentationResult(masks=masks, classes=np.array([0, 1, 2]),
                                  scores=np.array([0.9, 0.8, 0.5], np.float32),
                                  boxes2d=np.zeros((0, 4), np.float32))


def test_seem_adapter_matches_jax(tmp_path):
    res_j, res_t = seg_result(jseem), seg_result(tseem)
    np.testing.assert_array_equal(tseem.boxes2d_from_masks(res_t.masks),
                                  jseem.boxes2d_from_masks(res_j.masks))
    img = np.zeros((40, 60, 3), np.uint8)
    out_j = jseem.SeemSegmenter(backend=lambda _: seg_result(jseem))(img)
    out_t = tseem.SeemSegmenter(backend=lambda _: seg_result(tseem))(img)
    for field in ("masks", "classes", "scores", "boxes2d"):
        np.testing.assert_array_equal(getattr(out_t, field), getattr(out_j, field))
    seg = tseem.SeemSegmenter(backend=lambda _: seg_result(tseem))
    path = seg.cache_artifact(tmp_path, "000007", out_t)
    back_t = tseem.SeemSegmenter(backend="artifact", artifact_root=path.parent)(
        None, frame_id="000007")
    back_j = jseem.SeemSegmenter(backend="artifact", artifact_root=path.parent)(
        None, frame_id="000007")
    for field in ("masks", "classes", "scores", "boxes2d"):
        np.testing.assert_array_equal(getattr(back_t, field), getattr(back_j, field))


def test_seem_xdecoder_backend_raises_as_in_jax():
    with pytest.raises(ImportError) as want:
        jseem.SeemSegmenter(backend="xdecoder")
    with pytest.raises(ImportError) as got:
        tseem.SeemSegmenter(backend="xdecoder")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unknown SEEM backend"):
        tseem.SeemSegmenter(backend="nope")


# --- ops ----------------------------------------------------------------------

def test_sample_ground_triples_uniform_over_valid():
    valid = np.zeros(5000, bool)
    valid[100:3100:3] = True
    gen = torch.Generator().manual_seed(5)
    tri = tops.sample_ground_triples(t(valid), 128, gen)
    assert tri.shape == (128, 3) and tri.dtype == torch.int64
    assert valid[tri.numpy()].all()
    again = tops.sample_ground_triples(t(valid), 128, torch.Generator().manual_seed(5))
    assert torch.equal(tri, again)
    assert len(np.unique(tri.numpy())) > 300
    none = tops.sample_ground_triples(t(np.zeros(10, bool)), 4, gen)
    assert torch.equal(none, torch.zeros(4, 3, dtype=torch.int64))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ground_plane_and_above(seed):
    rng = np.random.RandomState(seed)
    n = 6000
    xy = rng.uniform(-40, 40, (n, 2))
    z = 0.02 * xy[:, 0] - 0.01 * xy[:, 1] - 1.6 + rng.normal(0, 0.03, n)
    objs = rng.uniform(-10, 10, (600, 3))
    objs[:, 2] = rng.uniform(-1.0, 1.5, 600)
    pts = np.concatenate([np.column_stack([xy, z]), objs]).astype(np.float32)
    valid = np.ones(len(pts), bool)
    valid[-50:] = False
    key = jax.random.PRNGKey(seed)
    plane_j, above_j = jax.device_get(jfactory._plane_and_above(pts, valid, key))
    plane_t, above_t = tops.plane_and_above(t(pts), t(valid), t(jax_triples(key, valid)))
    np.testing.assert_allclose(plane_t.numpy(), plane_j, rtol=0, atol=PLANE_TOL)
    np.testing.assert_array_equal(above_t.numpy(), above_j)


def test_outlier_masks_and_gate():
    ol, olv, op, opv = instances(3, k=5)
    radius = np.array([3.0, 0.6, 3.0, 0.6, 0.2], np.float32)
    lid_t = tops.radius_outlier_mask(t(ol), t(olv), t(radius))
    pse_t = tops.radius_outlier_mask(t(op), t(opv), t(radius))
    gate_t = tops.ball_gate_mask(t(op), pse_t, t(ol), lid_t, 0.1)
    lid_j = jax.vmap(jops.radius_outlier_mask)(ol, olv, radius)
    pse_j = jax.vmap(jops.radius_outlier_mask)(op, opv, radius)
    gate_j = jax.vmap(lambda a, b, c, d: jops.ball_gate_mask(a, b, c, d, 0.1))(
        op, pse_j, ol, lid_j)
    for got, want in ((lid_t, lid_j), (pse_t, pse_j), (gate_t, gate_j)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(gate_t.sum()) < int(opv.sum())
    no_lidar = tops.ball_gate_mask(t(op), t(opv), t(ol), t(np.zeros_like(olv)))
    assert not no_lidar.any()


def cc_cases():
    rng = np.random.RandomState(0)
    two = np.concatenate([rng.uniform(0, 1, (30, 3)) + [5, 0, 0],
                          rng.uniform(0, 1, (25, 3)) + [30, 20, 0]])
    # a chain 2.5 m apart (< R0) whose smallest index sits at the far end, so
    # the label must travel the chain's whole length
    chain = np.stack([np.arange(150)[::-1] * 2.5, np.zeros(150), np.zeros(150)], 1)
    scattered = rng.uniform(-40, 40, (200, 3)) * [1, 1, 0.05]
    return {"two_clusters": two, "long_chain": chain, "scattered": scattered}


@pytest.mark.parametrize("case", ["two_clusters", "long_chain", "scattered"])
def test_connected_components(case):
    pts, valid = padded(cc_cases()[case].astype(np.float32), 256)
    want = np.asarray(jops.connected_components(pts, valid))
    stats = {}
    got = tops.connected_components(t(pts), t(valid), stats=stats).numpy()
    np.testing.assert_array_equal(got, want)
    assert stats["syncs"] >= 1 and stats["sweeps"] == 2 * stats["syncs"]
    if case == "long_chain":
        assert len(set(got[:150].tolist())) == 1 and got[0] == 0
        assert stats["sweeps"] > 4   # the label crossed 150 points


@pytest.mark.parametrize("case", ["two_clusters", "long_chain", "scattered"])
def test_reach_and_adjacency(case):
    """reach is each valid point's BEV set, R_i = 3 + 0.001·‖p_i‖, held to
    float64 where no pair lies within 1e-4 m of its radius; adjacency is
    exactly reach·reachᵀ > 0."""
    pts, valid = padded(cc_cases()[case].astype(np.float32), 256)
    p = pts.astype(np.float64)
    r = 3.0 + 0.001 * np.linalg.norm(p, axis=-1)
    d = np.linalg.norm(p[:, None, :2] - p[None, :, :2], axis=-1)
    assert np.abs(d - r[:, None])[valid][:, valid].min() > 1e-4
    want = (d <= r[:, None]) & valid[None] & valid[:, None]
    np.testing.assert_array_equal(tops.reach(t(pts), t(valid)).numpy(), want)
    w = want.astype(np.int64)
    np.testing.assert_array_equal(tops.adjacency(t(pts), t(valid)).numpy(), (w @ w.T) > 0)


def test_top_cluster_masks_ties_at_the_boundary():
    # cluster sizes 9, 7, 7, 7, 3 (labels 0, 10, 20, 30, 40): three clusters
    # of 7 compete for the last two of num_clusters = 3 slots
    sizes = {0: 9, 10: 7, 20: 7, 30: 7, 40: 3}
    labels = np.full(64, 64, np.int32)
    pos = 0
    for lab, n in sizes.items():
        labels[pos:pos + n] = lab
        pos += n
    valid = labels < 64
    perm = np.random.RandomState(1).permutation(64)
    labels, valid = labels[perm], valid[perm]
    for k, min_pts in ((3, 5), (4, 5), (5, 1), (2, 8)):
        sel_j, cnt_j = jops.top_cluster_masks(jnp.asarray(labels), jnp.asarray(valid), k, min_pts)
        sel_t, cnt_t = tops.top_cluster_masks(t(labels).long(), t(valid), k, min_pts)
        np.testing.assert_array_equal(sel_t.numpy(), np.asarray(sel_j))
        np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))


@pytest.mark.parametrize("dtheta", [1.0, 0.5, 3.0])
def test_theta_grid_bit_for_bit(dtheta):
    d = np.deg2rad(dtheta)
    want = np.asarray(jax.jit(lambda: jnp.arange(0.0, np.pi / 2.0 - d, d))())
    got = tops.theta_grid(dtheta)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()


def jax_costs(x, y, valid):
    """JAX's own θ costs of ops.rectangle_search (ops.py:180-202), with its
    _masked_var."""
    thetas = jnp.asarray(tops.theta_grid())
    ct, st = jnp.cos(thetas), jnp.sin(thetas)
    c1 = x[None, :] * ct[:, None] + y[None, :] * st[:, None]
    c2 = -x[None, :] * st[:, None] + y[None, :] * ct[:, None]
    big = jnp.where(valid[None, :], 0.0, jops._BIG)
    d1 = jnp.minimum(jnp.max(c1 - big, 1, keepdims=True) - c1, c1 - jnp.min(c1 + big, 1,
                                                                           keepdims=True))
    d2 = jnp.minimum(jnp.max(c2 - big, 1, keepdims=True) - c2, c2 - jnp.min(c2 + big, 1,
                                                                           keepdims=True))
    e1 = ((d1 < d2) & valid[None, :]).astype(jnp.float32)
    e2 = ((~(d1 < d2)) & valid[None, :]).astype(jnp.float32)
    return np.asarray(-jops._masked_var(d1, e1) - jops._masked_var(d2, e2))


def test_rectangle_search():
    rng = np.random.RandomState(7)
    xs, ys, vs = [], [], []
    for _ in range(24):
        pts = boundary_points(rng, rng.uniform(5, 40), rng.uniform(-10, 10), rng.uniform(0.6, 5),
                              rng.uniform(0.5, 2), rng.uniform(-np.pi, np.pi),
                              n=rng.randint(6, 200))
        pts[:, :2] += rng.normal(0, rng.uniform(0, 0.1), (len(pts), 2))
        p, v = padded(pts, 256)
        xs.append(p[:, 0])
        ys.append(p[:, 1])
        vs.append(v)
    x, y, v = np.stack(xs), np.stack(ys), np.stack(vs)
    corners_j, theta_j = jax.vmap(jops.rectangle_search)(x, y, v)
    corners_t, theta_t = tops.rectangle_search(t(x), t(y), t(v))
    other = 0
    for i in range(len(x)):
        if float(theta_t[i]) != float(theta_j[i]):
            cost = jax_costs(jnp.asarray(x[i]), jnp.asarray(y[i]), jnp.asarray(v[i]))
            ti = int(np.argmin(np.abs(tops.theta_grid() - float(theta_t[i]))))
            gap = (cost.max() - cost[ti]) / abs(cost.max())
            assert gap <= THETA_GAP, (i, float(theta_t[i]), float(theta_j[i]), gap)
            other += 1
            continue
        np.testing.assert_allclose(corners_t[i].numpy(), np.asarray(corners_j[i]), rtol=0,
                                   atol=BOX_TOL)
    assert other <= 2


@pytest.mark.parametrize("center_type",
                         [None, "ori", "prior_centerline", "prior_linecorner", "prior_center"])
def test_box_from_corners(center_type):
    rng = np.random.RandomState(11)
    n = 40
    boxes = []
    for _ in range(n):
        length, width = rng.choice([rng.uniform(0.5, 2.0), rng.uniform(3, 5)]), rng.uniform(0.3, 2)
        pts = boundary_points(rng, rng.uniform(5, 30), rng.uniform(-5, 5), length, width,
                              rng.uniform(-np.pi, np.pi), 80)
        c, _ = tops.rectangle_search(t(pts[:, 0]), t(pts[:, 1]), torch.ones(80, dtype=torch.bool))
        boxes.append(c.numpy())
    corners = np.stack(boxes)
    max_z = rng.uniform(-1.0, 0.8, n).astype(np.float32)
    is_car = rng.rand(n) < 0.5
    size_prior = np.where(rng.rand(n, 1) < 0.7, [[3.9, 1.6]], -1.0).astype(np.float32)
    height_prior = np.where(rng.rand(n) < 0.7, 1.56, -1.0).astype(np.float32)
    for sp, hp in ((size_prior, height_prior), (None, None)):
        if sp is None and center_type not in (None, "ori"):
            continue
        box_j, ok_j = jax.vmap(lambda c, z, car, s, h: jops.box_from_corners(
            c, z, car, ground_z=-0.2, z_offset=1.5, size_prior=s, height_prior=h,
            center_type=center_type), in_axes=(0, 0, 0, None if sp is None else 0,
                                               None if hp is None else 0))(
            corners, max_z, is_car, sp, hp)
        box_t, ok_t = tops.box_from_corners(
            t(corners), t(max_z), t(is_car), ground_z=-0.2, z_offset=1.5,
            size_prior=None if sp is None else t(sp), height_prior=None if hp is None else t(hp),
            center_type=center_type)
        np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
        np.testing.assert_allclose(box_t.numpy(), np.asarray(box_j), rtol=0, atol=BOX_TOL)


@pytest.mark.parametrize("center_type", [None, "prior_center"])
def test_frame_program(center_type):
    ol, olv, op, opv = instances(5, k=6)
    radius = np.array([3.0, 3.0, 0.6, 3.0, 0.6, 3.0], np.float32)
    is_car = np.array([True, True, False, True, False, False])
    size_prior = np.array([[3.9, 1.6], [3.9, 1.6], [0.8, 0.6], [-1, -1], [0.8, 0.6], [-1, -1]],
                          np.float32)
    height_prior = np.array([1.56, -1, 1.73, 1.56, -1, -1], np.float32)
    kw = dict(num_clusters=4, min_pts=5, ball_gate_c=0.1, ground_z=-1.7, z_offset=0.0,
              center_type=center_type)
    want = jax.device_get(jfactory._frame_kernel(ol, olv, op, opv, radius, is_car, size_prior,
                                                 height_prior, **kw))
    stats = {}
    got = tops.frame_program(t(ol), t(olv), t(op), t(opv), t(radius), t(is_car),
                             t(size_prior), t(height_prior), stats=stats, **kw)
    boxes_t, ok_t, counts_t, n_obj_t = (g.numpy() for g in got)
    boxes_j, ok_j, counts_j, n_obj_j = want
    np.testing.assert_array_equal(ok_t, ok_j)
    np.testing.assert_array_equal(counts_t, counts_j)
    np.testing.assert_array_equal(n_obj_t, n_obj_j)
    np.testing.assert_allclose(boxes_t[ok_t], boxes_j[ok_j], rtol=0, atol=BOX_TOL)
    assert ok_t.sum() >= 4 and stats["syncs"] >= 1


# --- the factory --------------------------------------------------------------

def assert_outputs_equal(got, want):
    assert got.names == want.names
    for field in ("boxes_lidar", "scores", "boxes2d", "alphas"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.shape == b.shape, field
        np.testing.assert_allclose(a, b, rtol=0, atol=BOX_TOL, err_msg=field)
    assert got.fused_points.dtype == np.float16
    np.testing.assert_array_equal(got.fused_points, want.fused_points)


def run_both(frame_j, frame_t, **kw):
    """process_frame of the JAX factory and of the port (CPU) with JAX's
    triples."""
    jf = jfactory.PseudoBoxFactory(**kw)
    _, triples = frame_triples(jf.key, len(frame_j.lidar))
    want = jf.process_frame(frame_j)
    tf = tfactory.PseudoBoxFactory(device="cpu", **kw)
    got = tf.process_frame(frame_t, triples=triples)
    return got, want, tf


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_process_frame_small_caps(seed):
    (fj, _, _), (ft, _, _) = jsynth.make_scene(seed=seed), tsynth.make_scene(seed=seed)
    got, want, tf = run_both(fj, ft, max_points_per_instance=256, max_instances=6)
    assert_outputs_equal(got, want)
    assert len(got.boxes_lidar) > 0
    assert set(tf.last_times) == {"plane", "densify", "packing", "frame_program", "post_filter"}


def test_process_frame_at_the_defaults():
    (fj, _, _), (ft, _, _) = jsynth.make_scene(seed=3), tsynth.make_scene(seed=3)
    got, want, tf = run_both(fj, ft)
    assert_outputs_equal(got, want)
    assert tf.max_pts == 2048 and tf.max_instances == 16 and tf.last_stats["syncs"] >= 1


@pytest.mark.parametrize("center_type", [None, "prior_centerline", "prior_linecorner"])
def test_process_frame_kitti_preset(center_type):
    classes = ("Car", "Pedestrian", "Cyclist")
    (fj, _, _) = jsynth.make_scene(seed=4, class_names=classes)
    (ft, _, _) = tsynth.make_scene(seed=4, class_names=classes)
    preset = dict(jfactory.FACTORY_PRESETS["kitti"], center_type=center_type)
    assert preset.keys() == tfactory.FACTORY_PRESETS["kitti"].keys()
    got, want, _ = run_both(fj, ft, thing_classes=classes, max_points_per_instance=256,
                            max_instances=8, ground_z=-1.7, z_offset=0.0, **preset)
    assert_outputs_equal(got, want)
    assert {"Pedestrian", "Car"} <= set(got.names)


@pytest.mark.parametrize("seed", [0, 5])
def test_make_scene_matches_jax(seed):
    fj, gt_j, names_j = jsynth.make_scene(seed=seed, n_instances=6,
                                          class_names=("Car", "Pedestrian"))
    ft, gt_t, names_t = tsynth.make_scene(seed=seed, n_instances=6,
                                          class_names=("Car", "Pedestrian"))
    assert names_t == names_j and ft.frame_id == fj.frame_id
    np.testing.assert_array_equal(gt_t, gt_j)
    for field in ("lidar", "image", "depth", "masks", "classes", "scores", "boxes2d"):
        np.testing.assert_array_equal(getattr(ft, field), getattr(fj, field), err_msg=field)
    np.testing.assert_array_equal(ft.calib.P2, fj.calib.P2)


def test_written_frames_and_loaded_inputs_match_jax(tmp_path):
    """make_dataset, load_frame_inputs and write_frame against JAX's: the same
    bytes where no imaging library writes, the same pixels where one does."""
    ids_j = jsynth.make_dataset(tmp_path / "jax", n_train=2, n_val=1, n_instances=3)
    ids_t = tsynth.make_dataset(tmp_path / "port", n_train=2, n_val=1, n_instances=3)
    assert ids_t == ids_j
    for idx in ids_t[0] + ids_t[1]:
        for rel in (f"velodyne/{idx}.bin", f"calib/{idx}.txt", f"label_2/{idx}.txt",
                    f"depth/{idx}.npy", "ImageSets/train.txt", "ImageSets/val.txt"):
            assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()
        sj, st = (np.load(tmp_path / r / "seem" / f"{idx}.npz") for r in ("jax", "port"))
        assert set(sj.files) == set(st.files)
        for k in sj.files:
            np.testing.assert_array_equal(st[k], sj[k])
        np.testing.assert_array_equal(
            kitti_io.read_png(tmp_path / "port" / "image_2" / f"{idx}.png"),
            np.asarray(Image.open(tmp_path / "jax" / "image_2" / f"{idx}.png").convert("RGB")))
    fj = jfactory.load_frame_inputs(tmp_path / "jax", "000001")
    ft = tfactory.load_frame_inputs(tmp_path / "port", "000001")
    for field in ("lidar", "image", "depth", "masks", "classes", "scores", "boxes2d"):
        np.testing.assert_array_equal(getattr(ft, field), getattr(fj, field), err_msg=field)
    got, want, tf = run_both(fj, ft, max_points_per_instance=256, max_instances=4)
    jfactory.PseudoBoxFactory().write_frame(tmp_path / "jax", fj, want)
    tf.write_frame(tmp_path / "port", ft, got)
    np.testing.assert_array_equal(np.load(tmp_path / "port" / "velodyne_depth" / "000001.npy"),
                                  np.load(tmp_path / "jax" / "velodyne_depth" / "000001.npy"))
    lines = [(tmp_path / r / "label_train" / "000001.txt").read_text().splitlines()
             for r in ("port", "jax")]
    assert len(lines[0]) == len(lines[1]) == len(got.names) > 0
    for a, b in zip(*lines):
        a, b = a.split(), b.split()
        assert a[0] == b[0]
        np.testing.assert_allclose(np.float64(a[1:]), np.float64(b[1:]), rtol=0, atol=BOX_TOL)


def test_bev_recovery():
    gt = np.array([[10, 0, -1, 4, 2, 1.5, 0.3], [20, 5, -1, 4, 2, 1.5, -1.0]], np.float32)
    pred = gt[:1] + np.array([[0.1, 0, 0, 0, 0, 0, 0]], np.float32)
    rec = tsynth.bev_recovery(pred, gt)
    assert rec["gt"] == 2 and rec["recalled"] == 1
    assert rec["best_iou"][0] > 0.9 and rec["best_iou"][1] == 0.0
    assert tsynth.bev_recovery(np.zeros((0, 7)), gt)["recalled"] == 0


def test_factory_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfactory.PseudoBoxFactory()
    assert tfactory.PseudoBoxFactory(device="cpu").device.type == "cpu"
