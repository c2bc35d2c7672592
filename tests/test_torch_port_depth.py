"""Port parity: the depth completion nets of pipeline 2 against the JAX
package, fp32 on both sides, at 64 × 128.

* ENet (the compact net) and ENetRef (the reference-exact PENet ENet) with
  weights carried across from the flax tree by `params_from_jax` (ENetRef
  names its transposed convs "conv", so they are found by the port model's
  module type);
* ENetRef with one synthetic reference-keyed state dict loaded on both
  sides: JAX through apply_mapping(enet_mapping()), the port through
  `convert.load_enet_reference`;
* XLA's SAME padding of the compact net's convs at even and odd sizes, the
  depth CLI's crop, sparse depth and position plane.

Tolerance: max |port - JAX| within 1e-5 (ENet) and 1e-4 (ENetRef) of the
output's largest |value|; ENetRef stacks 1024-channel convs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dfu3d_tpu.models import depth_completion as jdc
from dfu3d_tpu.models import penet_ref as jref
from dfu3d_tpu.train import torch_convert as tc
from dfu3d_tpu_torch import convert
from dfu3d_tpu_torch.models import depth_completion as tdc
from dfu3d_tpu_torch.models import penet_ref as tref
from dfu3d_tpu_torch.tools import complete_depth as tcd

from test_torch_port_models import numpy_variables

H, W = 64, 128
ENET_TOL = 1e-5
REF_TOL = 1e-4
CU, CV, FU, FV = np.float32(61.5), np.float32(30.25), np.float32(700.0), np.float32(690.0)


def inputs(seed=0):
    rng = np.random.RandomState(seed)
    rgb = rng.rand(1, H, W, 3).astype(np.float32)
    d = (rng.rand(1, H, W, 1) * 40).astype(np.float32)
    d[rng.rand(*d.shape) > 0.08] = 0.0
    uu, vv = np.meshgrid(np.linspace(-1, 1, W, dtype=np.float32),
                         np.linspace(-1, 1, H, dtype=np.float32))
    pos = np.stack([uu, vv], -1)[None]
    K = np.array([[[FU, 0, CU], [0, FV, CV], [0, 0, 1]]], np.float32)
    return rgb, d, pos, K


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def assert_close(got, want, tol, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    scale = np.abs(want).max()
    assert scale > 0, name
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{name}: max |diff| {err} > {tol} x {scale}"


def ref_outputs(model, rgb, d, pos, K):
    with torch.no_grad():
        return model(nchw(rgb), nchw(d), nchw(pos), torch.from_numpy(K))


@pytest.mark.parametrize("size", [(8, 12), (9, 13), (7, 10)])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv_bn_relu_pads_as_xla(size, stride):
    x = np.random.RandomState(1).randn(2, *size, 5).astype(np.float32)
    jm = jdc.ConvBnRelu(6, stride=stride)
    v = numpy_variables(lambda: jm.init(jax.random.PRNGKey(0), x, train=False))
    want = jm.apply(v, x, train=False)
    port = convert.params_from_jax(jax.device_get(v), tdc.ConvBnRelu(5, 6, stride=stride))
    with torch.no_grad():
        got = port(nchw(x)).permute(0, 2, 3, 1).numpy()
    assert_close(got, want, ENET_TOL, f"ConvBnRelu {size} stride {stride}")


def test_enet_matches_flax():
    rgb, d, _, _ = inputs()
    jm = jdc.ENet()
    v = numpy_variables(lambda: jm.init(jax.random.PRNGKey(0), rgb, d, CU, CV, FU, FV))
    want = jm.apply(v, rgb, d, CU, CV, FU, FV)
    port = convert.params_from_jax(jax.device_get(v), tdc.ENet(device="cpu"))
    with torch.no_grad():
        got = port(nchw(rgb), nchw(d), CU, CV, FU, FV)
    for name, g, w in zip(("fused", "cd_depth", "dd_depth"), got, want):
        assert_close(g.permute(0, 2, 3, 1).numpy(), w, ENET_TOL, name)


def test_geometry_features_match_jax():
    _, d, pos, K = inputs(3)
    want = jdc.geometry_feature(d, CU, CV, FU, FV)
    got = tdc.geometry_feature(nchw(d), CU, CV, FU, FV).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, np.asarray(want))
    dd = nchw(d)
    m = torch.where(dd > 0, 1.0, 0.0)
    got_d, got_m = tref.sparse_downsample_close(dd, m)
    want_d, want_m = jref.sparse_downsample_close(d, (d > 0).astype(np.float32))
    np.testing.assert_array_equal(got_d.permute(0, 2, 3, 1).numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_m.permute(0, 2, 3, 1).numpy(), np.asarray(want_m))


@pytest.fixture(scope="module")
def enet_ref_flax():
    rgb, d, pos, K = inputs()
    jm = jref.ENetRef()
    v = numpy_variables(lambda: jm.init(jax.random.PRNGKey(0), rgb, d, pos, K))
    return jm, jax.device_get(v)


def test_enet_ref_matches_flax(enet_ref_flax):
    jm, v = enet_ref_flax
    rgb, d, pos, K = inputs()
    want = jm.apply(v, rgb, d, pos, K)
    port = convert.params_from_jax(v, tref.ENetRef(device="cpu"))
    got = ref_outputs(port, rgb, d, pos, K)
    for name in ("rgb_depth", "d_depth", "output", "feat_s1", "feat_s2", "feat_s4"):
        assert_close(got[name].permute(0, 2, 3, 1).numpy(), want[name], REF_TOL, name)


def test_transposed_convs_found_by_module_type(enet_ref_flax):
    """The transposed convs of ENetRef are named "conv": with the model they
    get the ConvTranspose layout (in, out, kh, kw) flipped in both spatial
    dims; by name alone they would not."""
    _, v = enet_ref_flax
    kernel = np.asarray(v["params"]["decoder_layer2"]["conv"]["kernel"])   # HWIO
    with_model = convert.params_from_jax(v, tref.ENetRef(device="cpu")).state_dict()
    np.testing.assert_array_equal(with_model["decoder_layer2.conv.weight"].numpy(),
                                  kernel.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])
    by_name = convert.params_from_jax(v)
    np.testing.assert_array_equal(by_name["decoder_layer2.conv.weight"].numpy(),
                                  kernel.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(with_model["depth_layer3.conv1.weight"].numpy(),
                                  by_name["depth_layer3.conv1.weight"].numpy())


def reference_state_dict(seed=0):
    """A state dict with the reference PENet's keys and shapes (plus its BN
    num_batches_tracked counters), drawn with numpy. Conv weights are
    LeCun-scaled: with He-scaled ones (and BN gains near 1) the two
    branches' confidences reach thousands, where the softmax fusion turns
    fp32 rounding of either side into differences of 1e-4 of the output."""
    rng = np.random.RandomState(seed)
    shapes = tref.ENetRef(device="meta").state_dict()
    state = {}
    for ours, ref in convert.enet_mapping().items():
        shape = tuple(shapes[ours].shape)
        if ref.endswith("running_var"):
            arr = rng.uniform(0.5, 1.5, shape)
        elif len(shape) == 4:
            arr = rng.normal(0, np.sqrt(1.0 / np.prod(shape[1:])), shape)
        else:
            arr = rng.normal(1.0 if ref.endswith(".weight") else 0.0, 0.1, shape)
        state[ref] = torch.from_numpy(arr.astype(np.float32))
        if ref.endswith("running_var"):
            state[ref[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(7)
    return state


def test_enet_mapping_equals_jax():
    """Every entry of the JAX package's enet_mapping names the same
    reference key as the port's, for the same parameter."""
    leaf = {"kernel": "weight", "scale": "weight", "bias": "bias", "mean": "running_mean",
            "var": "running_var"}
    want = {".".join(path[1:-1] + (leaf[path[-1]],)): ref
            for path, (ref, _) in tc.enet_mapping().items()}
    assert convert.enet_mapping() == want
    assert set(want) == set(tref.ENetRef(device="meta").state_dict())


def test_enet_ref_from_a_reference_checkpoint(enet_ref_flax, tmp_path):
    jm, v = enet_ref_flax
    state = reference_state_dict()
    torch.save({"model_state": state, "epoch": 3}, tmp_path / "pe.pth.tar")
    loaded = convert.load_torch_state(tmp_path / "pe.pth.tar")
    assert set(loaded) == set(state)
    new_v, report_j = tc.apply_mapping(v, {k: t.numpy() for k, t in state.items()},
                                       tc.enet_mapping())
    port = tref.ENetRef(device="cpu")
    report = convert.load_enet_reference(port, loaded)
    assert not report["missing_in_torch"] and not report["unmatched_ours"]
    assert sorted(report["converted"]) == sorted(report_j["converted"])
    rgb, d, pos, K = inputs(1)
    want = jm.apply(new_v, rgb, d, pos, K)
    got = ref_outputs(port, rgb, d, pos, K)
    for name in ("rgb_depth", "d_depth", "output"):
        assert_close(got[name].permute(0, 2, 3, 1).numpy(), want[name], REF_TOL, name)
    bad = dict(state)
    bad["decoder_layer6.0.weight"] = torch.zeros(2, 31, 3, 3)
    with pytest.raises(ValueError, match="shape mismatch"):
        convert.load_enet_reference(tref.ENetRef(device="cpu"), bad)
    partial = convert.load_enet_reference(
        tref.ENetRef(device="cpu"), {k: x for k, x in state.items() if "decoder" not in k})
    assert partial["missing_in_torch"] and all("decoder" in k for k in partial["missing_in_torch"])


def test_depth_nets_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdc.ENet()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tref.ENetRef()


def test_fp32_math_sets_tf32_for_the_block_only():
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    try:
        cudnn.allow_tf32 = matmul.allow_tf32 = True
        with tcd.fp32_math(False):
            assert not cudnn.allow_tf32 and not matmul.allow_tf32
        assert cudnn.allow_tf32 and matmul.allow_tf32
        cudnn.allow_tf32 = matmul.allow_tf32 = False
        with pytest.raises(ValueError):
            with tcd.fp32_math(True):
                assert cudnn.allow_tf32 and matmul.allow_tf32
                raise ValueError
        assert not cudnn.allow_tf32 and not matmul.allow_tf32
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


@pytest.mark.parametrize("full", [(370, 1242), (352, 1216), (300, 1000)])
def test_bottom_crop_matches_pil(full):
    rng = np.random.RandomState(2)
    img = rng.randint(0, 256, full + (3,)).astype(np.uint8)
    h, w = 352, 1216
    crop, left, top = tcd.bottom_crop(img, h, w)
    want_left, want_top = max((full[1] - w) // 2, 0), max(full[0] - h, 0)
    want = np.asarray(Image.fromarray(img).crop((want_left, want_top, want_left + w,
                                                 want_top + h)))
    assert (left, top) == (want_left, want_top)
    np.testing.assert_array_equal(crop, want)


def test_sparse_depth_and_position_plane_match_jax():
    import importlib.util
    from pathlib import Path

    from dfu3d_tpu.pseudo import synthetic as jsynth

    spec = importlib.util.spec_from_file_location(
        "jax_complete_depth", Path(__file__).resolve().parents[1] / "tools" / "complete_depth.py")
    jcd = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jcd)
    frame, _, _ = jsynth.make_scene(seed=1)
    np.testing.assert_array_equal(
        tcd.sparse_depth_from_lidar(frame.lidar, frame.calib, 352, 1216),
        jcd.sparse_depth_from_lidar(frame.lidar, frame.calib, 352, 1216))
    plane = tcd.position_plane(H, W)
    assert plane.shape == (2, H, W) and plane[0, 0, 0] == -1 and plane[0, 0, -1] == 1
    assert plane[1, 0, 0] == -1 and plane[1, -1, 0] == 1


def test_depth_net_macs():
    """The meta-device count of profile_pseudo against the layer tables:
    ENetRef's 3×3 convs, 1×1 shortcuts, 5×5 transposed convs and heads."""
    from dfu3d_tpu_torch.profile_pseudo import count_macs

    h, w = 352, 1216
    want = 0
    # rgb_conv_init and depth_conv_init: 5×5 at full size
    want += h * w * 32 * (4 + 2) * 25
    for layers in (tref.RGB_LAYERS, tref.DEPTH_LAYERS):
        s = 1
        for inp, out, st in layers:
            s *= st
            px = (h // s) * (w // s)
            want += px * out * ((inp + 3) + (out + 3)) * 9
            if st != 1 or inp != out:
                want += px * out * (inp + 3)
    for chans in ([1024] + [c for _, c in tref.RGB_DECODER], [1024] + tref.FUSION_DECODER):
        for i, (cin, cout) in enumerate(zip(chans[:-1], chans[1:])):
            s = 2 ** (5 - i)
            want += (h // s) * (w // s) * cin * cout * 25
    want += h * w * 32 * 2 * 9 * 2   # rgb_decoder_output and decoder_layer6
    assert count_macs("enet_ref", h, w) == want
    assert 0 < count_macs("enet", h, w) < want
