"""Port parity: reference (OpenPCDet / DFU3D) checkpoints of the flagship,
overlaid by `train/torch_convert.py` against the JAX package's
`convert_state_dict` followed by `params_from_jax`:

* a synthetic reference-keyed flagship state dict (shapes from the JAX
  mapping's inverse transforms, values from a seeded numpy generator, saved
  in the reference's checkpoint format): every tensor of the resulting port
  state_dict equal to the JAX route's, exactly (the transforms only move and
  concatenate numbers), and the reports equal (converted and missing
  reference keys in the same order, unmatched model keys under the port's
  names);
* a partial dict (no dense_head keys) leaves the head at its values and
  reports its keys missing, as the JAX overlay does;
* a dict with no key of the mapping raises; `load_checkpoint` tells the two
  formats apart by their keys, ignores the reference optimizer state and
  returns epoch 0;
* `tools.test --device cpu --ckpt ref.pth` runs on a tiny synthetic root
  with the flagship config, and `tools.train` takes a partial reference
  checkpoint through --pretrained_model and through --ckpt, logging the
  overlay's counts (those of the JAX report) as a warning.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from dfu3d_tpu.data.dataset import PointBatch as JPointBatch
from dfu3d_tpu.train import torch_convert as jtc
from dfu3d_tpu_torch.convert import load_torch_state, params_from_jax
from dfu3d_tpu_torch.data import kitti_synthetic
from dfu3d_tpu_torch.data.batch import synthetic_batch
from dfu3d_tpu_torch.flagship import TINY_RANGE, flagship
from dfu3d_tpu_torch.tools import create_infos, test as test_cli, train as train_cli
from dfu3d_tpu_torch.train import checkpoint, torch_convert
from dfu3d_tpu_torch.train.train_state import create_train_state

from test_torch_port_models import numpy_variables

REPO = Path(__file__).resolve().parents[1]
CFG = "cfgs/kitti_models/centerpoint_nuscenes2kitti.yaml"
BRANCH_OUT = {"center": 2, "center_z": 1, "dim": 3, "rot": 2}
HM_COUNTS = (1, 2, 2, 1, 2, 2)
_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias", "mean": "running_mean",
         "var": "running_var"}


@pytest.fixture(scope="module")
def variables():
    """Seeded flax variables of the JAX flagship (shapes by eval_shape)."""
    _, _, jmodel = graft._flagship(dtype=jnp.float32, tiny=True)
    jbatch = JPointBatch(*(t.numpy() for t in synthetic_batch(1, 256, 8, 12.0, seed=0)))
    return numpy_variables(
        lambda: jmodel.init({"params": jax.random.PRNGKey(0)}, jbatch, train=False,
                            method=lambda m, b, train: m._features(b, train)), seed=11)


def _leaves(variables):
    return {tuple(p.key for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(variables)[0]}


def _tower_out(ref_key):
    """Output channels of a reference head tower from its key."""
    head, name = re.search(r"heads_list\.(\d+)\.(\w+)\.", ref_key).groups()
    return HM_COUNTS[int(head)] if name == "hm" else BRANCH_OUT[name]


def reference_state(variables, seed=0, drop=None):
    """A reference-keyed flagship model_state of the shapes the JAX mapping
    reads from (each transform inverted on the shape), numpy draws."""
    rng = np.random.RandomState(seed)
    leaves = _leaves(variables)
    state = {}
    for ours, (ref, transform) in jtc.centerpoint_pillar_mapping().items():
        if ours not in leaves:
            continue
        s = leaves[ours].shape
        if isinstance(ref, tuple):
            if ours[-2:] == ("conv0", "kernel"):
                shapes = [(s[3] // len(ref), s[2], s[0], s[1])] * len(ref)
            elif ours[-2:] == ("out", "kernel"):
                shapes = [(_tower_out(r), s[2], s[0], s[1]) for r in ref]
            elif ours[-2:] == ("out", "bias"):
                shapes = [(_tower_out(r),) for r in ref]
            else:
                shapes = [(s[0] // len(ref),)] * len(ref)
            pairs = zip(ref, shapes)
        elif transform is jtc.t_linear:
            pairs = [(ref, (s[1], s[0]))]
        elif transform is jtc.t_conv2d:
            pairs = [(ref, (s[3], s[2], s[0], s[1]))]
        elif transform is jtc.t_convtranspose2d:
            pairs = [(ref, (s[2], s[3], s[0], s[1]))]
        else:
            pairs = [(ref, s)]
        for key, shape in pairs:
            if drop is None or not key.startswith(drop):
                state[key] = rng.normal(0, 0.5, shape).astype(np.float32)
    return state


def save_reference(path, state):
    torch.save({"model_state": {k: torch.from_numpy(v) for k, v in state.items()},
                "optimizer_state": {"state": {}, "param_groups": [{"lr": 0.1, "params": []}]},
                "epoch": 17, "it": 1234, "version": "pcdet+0.6.0"}, path)
    return path


def port_name(path):
    collection, *mods, leaf = path
    return ".".join([*mods, _LEAF[leaf]])


def port_model(variables):
    _, _, model = flagship(tiny=True, device="cpu")
    return params_from_jax(variables, model)


@pytest.mark.parametrize("drop", [None, "dense_head."])
def test_overlay_matches_jax(variables, tmp_path, drop):
    path = save_reference(tmp_path / "ref.pth", reference_state(variables, drop=drop))
    j_vars, j_report = jtc.convert_state_dict(variables, path)
    want = params_from_jax(j_vars)

    model = port_model(variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    report = torch_convert.load_reference_state(model, load_torch_state(path))
    got = model.state_dict()
    assert set(got) == set(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    assert report["converted"] == j_report["converted"]
    assert report["missing_in_torch"] == j_report["missing_in_torch"]
    assert sorted(report["unmatched_ours"]) == sorted(port_name(p)
                                                      for p in j_report["unmatched_ours"])
    changed = {k for k in got if not torch.equal(got[k], before[k])}
    if drop is None:
        assert not report["missing_in_torch"] and changed == set(got)
        assert len(report["converted"]) == len(got)
    else:
        # the head keeps its values; everything else is overlaid
        assert changed == {k for k in got if not k.startswith("dense_head.")}
        assert report["missing_in_torch"] and all(
            k.startswith("dense_head.") for k in report["missing_in_torch"])


def test_formats_told_apart_by_keys(variables, tmp_path):
    ref = save_reference(tmp_path / "ref.pth", reference_state(variables))
    model = port_model(variables)
    state = create_train_state(model, flagship(tiny=True, device="cpu")[0].OPTIMIZATION, 10)
    own = checkpoint.save_checkpoint(tmp_path / "ckpt", state, epoch=3)
    assert not torch_convert.is_reference_state(torch.load(own)["model_state"])
    assert torch_convert.is_reference_state(torch.load(ref)["model_state"])

    opt_before = state.optimizer.state_dict()
    state, epoch = checkpoint.load_checkpoint(ref, state)
    assert epoch == 0
    assert state.optimizer.state_dict() == opt_before       # the reference optimizer is ignored
    j_vars, _ = jtc.convert_state_dict(variables, ref)
    for k, v in params_from_jax(j_vars).items():
        assert torch.equal(state.model.state_dict()[k], v), k
    with pytest.raises(ValueError, match="reference checkpoint"):
        checkpoint.load_checkpoint(ref)
    assert checkpoint.load_checkpoint(own)[1] == 3
    fresh = port_model(variables)
    assert checkpoint.load_model_state(ref, fresh)[0] == 0


def test_no_matching_key_raises(variables, tmp_path):
    other = {"backbone_3d.conv_input.0.weight": np.zeros((16, 3, 3, 3, 4), np.float32),
             "backbone_2d.blocks.0.1.weight": np.zeros((1, 1, 3, 3), np.float32)}
    path = save_reference(tmp_path / "other.pth", other)
    model = port_model(variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    # a shape that does not fit raises too, before anything is loaded
    with pytest.raises(ValueError, match="shape mismatch"):
        torch_convert.load_reference_state(model, load_torch_state(path))
    del other["backbone_2d.blocks.0.1.weight"]
    other["dense_head.heads_list.0.unknown.weight"] = np.zeros(3, np.float32)
    path = save_reference(tmp_path / "other.pth", other)
    with pytest.raises(ValueError, match="no key"):
        torch_convert.load_reference_state(model, load_torch_state(path))
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


@pytest.fixture(scope="module")
def flagship_root(tmp_path_factory, variables):
    """A tiny KITTI root laid out for the flagship config, a work directory
    whose cfgs/ is tools/cfgs/, and a reference checkpoint."""
    work = tmp_path_factory.mktemp("ref_work")
    (work / "cfgs").symlink_to(REPO / "tools" / "cfgs")
    root = work / "root"
    kitti_synthetic.write_root(root, 4, 2, flagship(tiny=True, device="cpu")[0].CLASS_NAMES,
                               seed=2, num_points=(800, 1200), num_boxes=(4, 7), near_cars=2)
    mp = pytest.MonkeyPatch()
    mp.chdir(work)
    try:
        out = create_infos.main(["--cfg_file", CFG, "--data_path", str(root)])
    finally:
        mp.undo()
    out["dbinfos"].rename(root / "nuscenes2kitti_dbinfos_train_28130.pkl")
    ref = save_reference(work / "ref.pth", reference_state(variables, seed=4))
    return work, root, ref


def _overrides(root):
    return ["--set", "DATA_CONFIG.DATA_PATH", str(root),
            "DATA_CONFIG.POINT_CLOUD_RANGE", str(list(TINY_RANGE)),
            "DATA_CONFIG.MAX_POINTS_PER_FRAME", "4096",
            "DATA_CONFIG.INFO_PATH.train", "['kitti_infos_train.pkl']",
            "DATA_CONFIG.INFO_PATH.test", "['kitti_infos_val.pkl']"]


def test_cli_test_takes_a_reference_checkpoint(flagship_root):
    """tools.test --ckpt ref.pth evaluates the overlaid model as epoch 0
    (NMS_PRE_MAXSIZE cut to 100 to keep the plain overlap short on the CPU;
    tools.train --ckpt goes through the load_checkpoint tested above)."""
    work, root, ref = flagship_root
    cpu = ["--device", "cpu", "--dtype", "float32", "--workers", "1", "--batch_size", "2"]
    mp = pytest.MonkeyPatch()
    mp.chdir(work)
    try:
        ((epoch, result_dir, result),) = test_cli.main(
            ["--cfg_file", CFG, "--ckpt", str(ref), "--save_to_file", *cpu, *_overrides(root),
             "MODEL.DENSE_HEAD.POST_PROCESSING.NMS_CONFIG.NMS_PRE_MAXSIZE", "100"])
    finally:
        mp.undo()
    assert epoch == 0 and result_dir.parts[-3:] == ("epoch_0", "val", "default")
    assert result["num_frames"] == 2
    assert len(list((work / result_dir / "final_result" / "data").glob("*.txt"))) == 2
    log = next((work / result_dir).parents[2].glob("log_eval_*.txt")).read_text()
    assert "reference checkpoint" in log and "keys converted" in log


@pytest.mark.parametrize("flag", ["--pretrained_model", "--ckpt"])
def test_cli_train_logs_a_partial_reference_checkpoint(flagship_root, variables, flag):
    """tools.train with a reference checkpoint that lacks the head's keys:
    the overlay's counts reach the train log as a warning (the head keeps
    its initial values), and training runs from epoch 0."""
    work, root, _ = flagship_root
    tag = flag.strip("-")
    partial = save_reference(work / f"partial_{tag}.pth",
                             reference_state(variables, seed=5, drop="dense_head."))
    _, j_report = jtc.convert_state_dict(variables, partial)
    cpu = ["--device", "cpu", "--dtype", "float32", "--workers", "1", "--batch_size", "2"]
    mp = pytest.MonkeyPatch()
    mp.chdir(work)
    try:
        out = train_cli.main(["--cfg_file", CFG, flag, str(partial), "--epochs", "1",
                              "--extra_tag", tag, *cpu, *_overrides(root)])
    finally:
        mp.undo()
    assert out["start_epoch"] == 0 and len(out["epochs"]) == 1
    log = next((work / out["output_dir"]).glob("log_train_*.txt")).read_text()
    n_missing = len(j_report["missing_in_torch"])
    assert n_missing and all(k.startswith("dense_head.") for k in j_report["missing_in_torch"])
    line = next(l for l in log.splitlines() if "reference checkpoint:" in l)
    assert "WARNING" in line
    assert f"{len(j_report['converted'])} keys converted, {n_missing} missing" in line
