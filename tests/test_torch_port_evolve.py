"""Port parity: pipeline 4's scripts, `tools.e2e_synthetic` and
`tools.evolve`, against the JAX package's tools/e2e_synthetic.py and
tools/evolve.py (imported by path):

* `head_groups`, `build_cfg` (pillar and voxel, 1 and 3 classes) and
  `factory_quality` on the same label dirs: equal;
* the epoch pick, with epoch_9, epoch_10 and epoch_12 present: the port
  takes 12 by number where the JAX scripts' lexicographic `sorted` takes 9
  (both asserted, so the difference stays pinned);
* the round filter on hand-made prediction txts: the plain threshold, the
  weak-model relaxation (70th percentile of the scores, at least 0.1) and
  the error when no box survives;
* one self-evolution round as a whole from the same weights (build_cfg's
  2-class pillar model, seeded numpy weights carried across with
  `params_from_jax`): the JAX script's `_run_evolve` (its predict pass run
  in process, fp32) and the port's, both up to the retrain, give the same
  label_refine0 txts (names equal, numbers within LABEL_TOL, as sets) and
  the same rebuilt infos (names, boxes within LABEL_TOL, points in boxes)
  and gt database counts;
* `tools.evolve` on the CPU: one round from disk, its label dir equal to
  the newest epoch's predictions and its infos counting their boxes;
* one tiny `e2e_synthetic --device cpu --evolve_rounds 1` that finishes
  with both AP lines.
"""
import importlib.util
import json
import pickle
import shutil
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
import yaml

from dfu3d_tpu.data.kitti_dataset import KittiDataset as JKittiDataset
from dfu3d_tpu.data.kitti_dataset import create_kitti_infos as j_create_kitti_infos
from dfu3d_tpu.train.checkpoint import save_checkpoint as j_save_checkpoint
from dfu3d_tpu.utils.config import CfgDict as JCfgDict
from dfu3d_tpu_torch.convert import params_from_jax
from dfu3d_tpu_torch.data import kitti_synthetic
from dfu3d_tpu_torch.tools import create_infos, e2e_synthetic, evolve
from dfu3d_tpu_torch.tools import common as tools_common
from dfu3d_tpu_torch.tools.common import newest_epoch_dir
from dfu3d_tpu_torch.train import checkpoint
from dfu3d_tpu_torch.train.train_state import create_train_state
from dfu3d_tpu_torch.utils.config import CfgDict, cfg_from_yaml_file

from test_torch_port_models import numpy_variables

REPO = Path(__file__).resolve().parents[1]
CLASSES = ["Car", "Pedestrian", "Cyclist"]
ROUND_CLASSES = ["Car", "Pedestrian"]   # kitti_synthetic's classes; two heads (vehicles, VRUs)
HM_SHIFT = 1.0
SMALL_RANGE = [0.0, -12.8, -5.0, 25.6, 12.8, 3.0]
TEST_THREADS = 2
LABEL_TOL = 1e-3     # printed KITTI numbers (4 decimals; fp32 on both sides)
CPU = ["--device", "cpu", "--dtype", "float32"]


@pytest.fixture
def few_threads():
    """Two intra-op threads for the small CLI-driven models: with several test
    workers on the machine, each process's default thread pool makes these
    runs tens of times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(TEST_THREADS)
    yield
    torch.set_num_threads(n)


def jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


J_E2E = jax_tool("e2e_synthetic")


@pytest.mark.parametrize("model", ["pillar", "voxel"])
@pytest.mark.parametrize("classes", [["Car"], CLASSES])
def test_build_cfg_equals_jax(tmp_path, model, classes):
    assert e2e_synthetic.head_groups(classes) == J_E2E.head_groups(classes)
    got = e2e_synthetic.build_cfg(tmp_path / "data", tmp_path / "port", 4, model, classes)
    want = J_E2E.build_cfg(tmp_path / "data", tmp_path / "jax", 4, model, classes)
    assert got.relative_to(tmp_path / "port") == want.relative_to(tmp_path / "jax")
    assert got.read_text() == want.read_text()


def _write_labels(path, rng, n, classes):
    rows = []
    for _ in range(n):
        c = classes[rng.randint(len(classes))]
        x, z = rng.uniform(-10, 10), rng.uniform(5, 40)
        rows.append(f"{c} 0.00 0 0.00 0.00 0.00 50.00 50.00 1.50 {rng.uniform(0.5, 2):.2f} "
                    f"{rng.uniform(0.5, 4.5):.2f} {x:.2f} 1.60 {z:.2f} {rng.uniform(-3, 3):.2f}")
    path.write_text("\n".join(rows) + ("\n" if rows else ""))


def test_factory_quality_equals_jax(tmp_path):
    """Pseudo labels are the gt jittered, with some dropped and some extra
    boxes; a frame without a pseudo-label file counts its gt as missed."""
    rng = np.random.RandomState(3)
    root = tmp_path / "data"
    for d in ("label_2", "label_train", "ImageSets"):
        (root / d).mkdir(parents=True)
    ids = [f"{i:06d}" for i in range(6)]
    (root / "ImageSets" / "train.txt").write_text("\n".join(ids) + "\n")
    for k, idx in enumerate(ids):
        _write_labels(root / "label_2" / f"{idx}.txt", rng, rng.randint(0, 8), CLASSES)
        if k == 5:
            continue
        gt = (root / "label_2" / f"{idx}.txt").read_text().splitlines()
        pseudo = []
        for line in gt:
            if rng.uniform() < 0.2:
                continue
            v = line.split()
            for j in (11, 13):
                v[j] = f"{float(v[j]) + rng.normal(0, 0.4):.2f}"
            pseudo.append(" ".join(v))
        extra = root / "extra.txt"
        _write_labels(extra, rng, rng.randint(0, 3), CLASSES)
        pseudo += extra.read_text().splitlines()
        (root / "label_train" / f"{idx}.txt").write_text("\n".join(pseudo) + "\n")
    got = e2e_synthetic.factory_quality(root, CLASSES)
    assert got == J_E2E.factory_quality(root, CLASSES)
    assert all(0 < got[c]["tp"] and got[c]["fp"] + got[c]["fn"] > 0 for c in CLASSES)


def test_newest_epoch_by_number_where_jax_sorts_names(tmp_path):
    """epoch_9, epoch_10 and epoch_12 present: the port takes 12; the JAX
    scripts' sorted(...)[-1] (tools/evolve.py:82, tools/e2e_synthetic.py:305,
    :355, :491) takes 9."""
    ckpt_dir = tmp_path / "ckpt"
    ckpt_dir.mkdir()
    for e in (9, 10, 12):
        (ckpt_dir / f"checkpoint_epoch_{e}.pth").write_bytes(b"")
        d = tmp_path / "eval" / f"epoch_{e}" / "train" / "predict_refine0" / "final_result" / "data"
        d.mkdir(parents=True)
        (tmp_path / "eval" / f"epoch_{e}" / "train" / "final_result" / "data").mkdir(parents=True)
    assert e2e_synthetic.newest_checkpoint(ckpt_dir).name == "checkpoint_epoch_12.pth"
    assert sorted(ckpt_dir.glob("checkpoint_epoch_*"))[-1].name == "checkpoint_epoch_9.pth"
    rel = "train/predict_refine0/final_result/data"
    assert newest_epoch_dir(tmp_path / "eval", rel).parts[-5] == "epoch_12"
    assert sorted(tmp_path.glob(f"eval/epoch_*/{rel}"))[-1].parts[-5] == "epoch_9"
    rel = "train/final_result/data"
    assert newest_epoch_dir(tmp_path / "eval", rel).parts[-4] == "epoch_12"
    assert sorted(tmp_path.glob(f"eval/epoch_*/{rel}"))[-1].parts[-4] == "epoch_9"
    with pytest.raises(FileNotFoundError):
        e2e_synthetic.newest_checkpoint(tmp_path / "none")


def _pred_line(score, name="Car"):
    return (f"{name} -1 -1 0.1000 10.0000 20.0000 30.0000 40.0000 1.5000 1.6000 3.9000 "
            f"1.0000 1.5000 20.0000 0.3000 {score:.4f}")


@pytest.mark.parametrize("case", ["plain", "relaxed", "none"])
def test_filter_round(tmp_path, case):
    pred = tmp_path / "pred"
    pred.mkdir()
    scores = {"plain": [[0.9, 0.51, 0.2], [0.5, 0.49], []],
              "relaxed": [[0.42, 0.3, 0.12], [0.25, 0.15], [0.11]],
              "none": [[], [], []]}[case]
    frames = ["000000", "000001", "000002"]
    for f, s in zip(frames, scores):
        lines = [_pred_line(v) for v in s] + ["Car 0 0"]     # a short line is skipped
        (pred / f"{f}.txt").write_text("\n".join(lines) + "\n")
    out = tmp_path / "label_refine0"
    if case == "none":
        with pytest.raises(RuntimeError, match="no predictions survived"):
            e2e_synthetic.filter_round(pred, frames, out, 0.5)
        return
    got = e2e_synthetic.filter_round(pred, frames, out, 0.5)
    flat = [v for s in scores for v in s]
    thresh = 0.5 if case == "plain" else max(0.1, float(np.percentile(flat, 70.0)))
    assert got == {"kept": sum(v >= thresh for v in flat), "total": len(flat), "thresh": thresh}
    for f, s in zip(frames, scores):
        kept = [line for line in (out / f"{f}.txt").read_text().splitlines() if line]
        assert [float(line.split()[15]) for line in kept] == [
            float(f"{v:.4f}") for v in s if v >= thresh]


# ---------------------------------------------------------------------------
# one round as a whole, from the same weights
# ---------------------------------------------------------------------------

class _StopAtRetrain(Exception):
    pass


def _shrink(cfg_file, **data_cfg):
    """The config on a 128 × 128 BEV grid with 64 NMS candidates per head, so
    that the CPU runs stay short; `data_cfg` adds DATA_CONFIG keys."""
    cfg = yaml.safe_load(cfg_file.read_text())
    cfg["DATA_CONFIG"]["POINT_CLOUD_RANGE"] = SMALL_RANGE
    cfg["DATA_CONFIG"].update(data_cfg)
    cfg["MODEL"]["DENSE_HEAD"]["POST_PROCESSING"]["NMS_CONFIG"]["NMS_PRE_MAXSIZE"] = 64
    cfg_file.write_text(yaml.safe_dump(cfg))
    return cfg


def _seeded_variables(params, batch_stats):
    variables = numpy_variables(lambda: {"params": params, "batch_stats": batch_stats}, seed=5,
                                gains={"vfe/pfn_0/Dense_0/kernel": 0.3,
                                       "dense_head/fused_heads/out/kernel": 0.4})
    # boxes of a few metres (exp(dim) ≈ e): branch b of head h at out
    # channels out_max · (5h + b) (center, center_z, dim, rot, hm)
    out = variables["params"]["dense_head"]["fused_heads"]["out"]
    bias = np.array(out["bias"])
    out_max = bias.shape[0] // (5 * 2)
    for h in range(2):
        bias[out_max * (5 * h + 2):out_max * (5 * h + 3)] += 1.0
        # heat-map logits lowered so that the kept scores straddle 0.5
        bias[out_max * (5 * h + 4):out_max * (5 * h + 5)] -= HM_SHIFT
    out["bias"] = bias
    return variables


@pytest.fixture(scope="module")
def round_outputs(tmp_path_factory):
    """The same 4-frame train split, infos and weights on each side; then each
    script's refine round up to its retrain."""
    threads = torch.get_num_threads()
    torch.set_num_threads(TEST_THREADS)
    try:
        return _round_outputs(tmp_path_factory)
    finally:
        torch.set_num_threads(threads)


def _round_outputs(tmp_path_factory):
    base = tmp_path_factory.mktemp("round")
    seed_root = base / "seed"
    kitti_synthetic.write_root(seed_root, 4, 1, ROUND_CLASSES, seed=6, num_points=(2000, 3000),
                               num_boxes=(6, 9), near_cars=3)
    shutil.copytree(seed_root / "label_2", seed_root / "label_train")
    sides = {}
    for side in ("jax", "port"):
        work = base / side
        root = work / "data"
        shutil.copytree(seed_root, root)
        build = J_E2E.build_cfg if side == "jax" else e2e_synthetic.build_cfg
        cfg_file = build(root, work, batch_size=2, model="pillar", class_names=ROUND_CLASSES)
        sides[side] = (work, root, cfg_file, _shrink(cfg_file))
    # initial infos and gt database, each package its own
    work, root, _, full_cfg = sides["jax"]
    ds_cfg = JCfgDict(full_cfg["DATA_CONFIG"])
    j_create_kitti_infos(ds_cfg, ROUND_CLASSES, root, root, splits=("train",))
    work, root, _, full_cfg = sides["port"]
    e2e_synthetic.build_infos(full_cfg, ROUND_CLASSES, root, "label_train", "train", gt_database=False)

    # JAX weights → orbax checkpoint; the same weights → the port's checkpoint
    jtest = jax_tool("test")
    work, root, cfg_file, full_cfg = sides["jax"]
    rel_cfg = str(cfg_file.relative_to(work))
    mp = pytest.MonkeyPatch()
    mp.chdir(work)
    mp.setattr(sys, "argv", ["test.py", "--cfg_file", rel_cfg, "--batch_size", "2", "--dtype",
                             "float32", "--set", "DATA_CONFIG.DATA_SPLIT.test", "train",
                             "DATA_CONFIG.INFO_PATH.test", "['kitti_infos_train.pkl']"])
    try:
        args, jcfg = jtest.parse_config()
        from dfu3d_tpu.utils.common import create_logger
        _, state, _, _ = jtest._build(args, jcfg, create_logger())
    finally:
        mp.undo()
    variables = _seeded_variables(state.params, state.batch_stats)
    state = state._replace(params=variables["params"], batch_stats=variables["batch_stats"])
    j_ckpt = j_save_checkpoint(work / "ckpt", state, epoch=3)

    pwork, proot, pcfg_file, pfull_cfg = sides["port"]
    pcfg = cfg_from_yaml_file(pcfg_file, CfgDict())
    model = tools_common.build_model(pcfg, "test", "cpu")
    params_from_jax(jax.device_get(variables), model)
    p_ckpt = checkpoint.save_checkpoint(pwork / "ckpt",
                                        create_train_state(model, pcfg.OPTIMIZATION, 1), epoch=3)

    # the JAX round: its predict subprocess run in process in fp32, stopped
    # at the retrain
    def fake_run(cmd, cwd=None, **kw):
        script = Path(cmd[1]).name
        if script == "train.py":
            raise _StopAtRetrain()
        assert script == "test.py", cmd
        argv = [str(c) for c in cmd[2:]]
        at = argv.index("--set")
        argv[at:at] = ["--dtype", "float32", "--batch_size", "2"]
        with pytest.MonkeyPatch.context() as m:
            m.chdir(cwd)
            m.setattr(sys, "argv", ["test.py", *argv])
            jtest.main()
        return SimpleNamespace(returncode=0, stdout="", stderr="")

    rounds = SimpleNamespace(start_refine=0, evolve_rounds=1, evolve_thresh=0.5, epochs=1)
    out_dir = work / "output" / "synthetic" / cfg_file.stem / "default"
    with pytest.MonkeyPatch.context() as m:
        m.setattr(J_E2E.subprocess, "run", fake_run)
        with pytest.raises(_StopAtRetrain):
            J_E2E._run_evolve(rounds, work, root, {}, rel_cfg, out_dir, [j_ckpt], {"value": 0.0},
                              full_cfg, JKittiDataset, j_create_kitti_infos, JCfgDict, ROUND_CLASSES)

    def stop(argv):
        raise _StopAtRetrain()

    run = dict(args=rounds, workdir=pwork, root=proot,
               rel_cfg=str(pcfg_file.relative_to(pwork)), full_cfg=pfull_cfg,
               class_names=ROUND_CLASSES, device=CPU)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(e2e_synthetic.train_cli, "main", stop)
        with pytest.raises(_StopAtRetrain):
            e2e_synthetic._run_evolve(run, p_ckpt, {"value": 0.0})
    return sides


def _parse(path):
    rows = [line.split() for line in path.read_text().splitlines() if line.strip()]
    return [r[0] for r in rows], np.array([[float(x) for x in r[1:]] for r in rows],
                                          dtype=np.float64).reshape(len(rows), 15)


def _match(a, b, tol):
    """Rows of b matched one to one to rows of a within tol (max abs)."""
    assert a.shape == b.shape
    if not len(a):
        return np.zeros(0, int)
    dist = np.abs(a[:, None] - b[None]).max(-1)
    match = dist.argmin(0)
    assert len(set(match.tolist())) == len(match)
    assert dist[match, np.arange(len(match))].max() <= tol
    return match


def test_round_labels_equal_jax(round_outputs):
    (_, jroot, _, _), (_, proot, _, _) = round_outputs["jax"], round_outputs["port"]
    jfiles = sorted(p.name for p in (jroot / "label_refine0").glob("*.txt"))
    assert jfiles == sorted(p.name for p in (proot / "label_refine0").glob("*.txt"))
    assert len(jfiles) == 4
    kept = 0
    for name in jfiles:
        jn, jv = _parse(jroot / "label_refine0" / name)
        pn, pv = _parse(proot / "label_refine0" / name)
        match = _match(jv, pv, LABEL_TOL)
        assert [jn[i] for i in match] == pn
        kept += len(pn)
    # the round keeps some boxes and drops others (score column 15 at 0.5)
    pred = next((proot.parent / "output").rglob("predict_refine0/final_result/data"))
    total = sum(len(_parse(p)[0]) for p in pred.glob("*.txt"))
    assert 0 < kept < total


def test_round_infos_equal_jax(round_outputs):
    (_, jroot, _, _), (_, proot, _, _) = round_outputs["jax"], round_outputs["port"]
    with open(jroot / "kitti_infos_train.pkl", "rb") as f:
        jinfos = pickle.load(f)
    with open(proot / "kitti_infos_train.pkl", "rb") as f:
        pinfos = pickle.load(f)
    assert [i["point_cloud"]["lidar_idx"] for i in jinfos] == \
        [i["point_cloud"]["lidar_idx"] for i in pinfos]
    for ji, pi in zip(jinfos, pinfos):
        ja, pa = ji["annos"], pi["annos"]
        n = len(_parse(proot / "label_refine0" / f"{pi['point_cloud']['lidar_idx']}.txt")[0])
        assert len(pa["name"]) == n          # the infos count the refined labels' boxes
        match = _match(np.asarray(ja["gt_boxes_lidar"]), np.asarray(pa["gt_boxes_lidar"]),
                       LABEL_TOL)
        assert list(np.asarray(ja["name"])[match]) == list(pa["name"])
        if n:   # an empty frame's annos carry no point counts
            np.testing.assert_array_equal(np.asarray(ja["num_points_in_gt"])[match],
                                          pa["num_points_in_gt"])
    with open(jroot / "kitti_dbinfos_train.pkl", "rb") as f:
        jdb = pickle.load(f)
    with open(proot / "kitti_dbinfos_train.pkl", "rb") as f:
        pdb = pickle.load(f)
    assert {k: len(v) for k, v in jdb.items()} == {k: len(v) for k, v in pdb.items()}


# ---------------------------------------------------------------------------
# the scripts end to end on the CPU
# ---------------------------------------------------------------------------

def _confident_head(monkeypatch):
    """Start every model the CLIs build from a heat-map bias of +1 instead of
    -2.19, so that a model trained one short epoch on a few frames still emits
    boxes above SCORE_THRESH and the refine round has labels to keep (the
    scripts are under test here, not the detector)."""
    build = tools_common.build_network

    def confident(*args, **kw):
        model = build(*args, **kw)
        head = model.dense_head.fused_heads
        with torch.no_grad():
            for i, (_, name, oc) in enumerate(head.branch_specs):
                if name == "hm":
                    head.out.bias[i * head.out_max:i * head.out_max + oc] = 1.0
        return model

    monkeypatch.setattr(tools_common, "build_network", confident)


def test_evolve_round_from_disk(tmp_path, monkeypatch, few_threads):
    """tools.evolve --rounds 1 on the tiny config laid out as the flagship
    dataset config names its files: the next round's labels are the newest
    epoch's predictions, and the rebuilt infos count their boxes."""
    _confident_head(monkeypatch)
    root = tmp_path / "data"
    kitti_synthetic.write_root(root, 4, 1, ROUND_CLASSES, seed=7, num_points=(800, 1200),
                               num_boxes=(4, 7), near_cars=2)
    cfg_file = e2e_synthetic.build_cfg(root, tmp_path, batch_size=2, class_names=ROUND_CLASSES)
    _shrink(cfg_file, PSEUDO_LABEL_ROUND="initial")   # as the flagship dataset config
    rel = str(cfg_file.relative_to(tmp_path))
    monkeypatch.chdir(tmp_path)
    out = create_infos.main(["--cfg_file", rel, "--label_dir", "label_2", "--splits", "train"])
    out["infos"][0].rename(root / evolve.round_info_name("initial"))
    (rec,) = evolve.main(["--cfg_file", rel, "--rounds", "1", "--epochs", "2",
                          "--score_thresh", "0.1", *CPU, "--set", "OPTIMIZATION.LR", "0.0001"])
    assert [p[0] for p in rec["predictions"]] == [1, 2]       # --eval_all: every epoch
    assert rec["prediction_dir"].parts[-4] == "epoch_2"
    newest = rec["prediction_dir"]
    labels = root / "label_refine0"
    assert sorted(p.name for p in labels.glob("*.txt")) == sorted(p.name for p in newest.glob("*"))
    for p in labels.glob("*.txt"):
        assert p.read_bytes() == (newest / p.name).read_bytes()
    with open(rec["next_info"], "rb") as f:
        infos = pickle.load(f)
    counts = {i["point_cloud"]["lidar_idx"]: len(i["annos"]["name"]) for i in infos}
    assert counts == {p.stem: len(p.read_text().splitlines()) for p in labels.glob("*.txt")}
    assert sum(counts.values()) > 0
    assert (root / "kitti_infos_train_refine0_pseudo_box.pkl").exists()
    # the next round reads the file the flagship config names
    assert rec["next_info"].name == "nuscenes2kitti_infos_train_28130_refine0_pseudo_box.pkl"


def test_e2e_synthetic_tiny(tmp_path, monkeypatch, capsys, few_threads):
    _confident_head(monkeypatch)
    out = e2e_synthetic.main(["--workdir", str(tmp_path), "--n_train", "1", "--n_val", "1",
                              "--epochs", "1", "--batch_size", "1", "--evolve_rounds", "1",
                              *CPU])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    metrics = [line["metric"] for line in lines]
    assert metrics == ["synthetic_e2e_ap3d_moderate_R40",
                       "synthetic_e2e_ap3d_moderate_R40_refine0"]
    assert lines[1]["ap_history"] == out["ap_history"] and len(out["ap_history"]) == 2
    (rnd,) = out["rounds"]
    assert rnd["kept"] > 0 and rnd["predicted_epoch"] == 1
    assert set(out["factory_quality"]) == {"Car"}
    assert {"pseudo_boxes", "infos", "train", "eval"} <= set(out["seconds"])
    assert {"predict", "filter", "rebuild", "train", "eval"} == set(rnd["seconds"])
