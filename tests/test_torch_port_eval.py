"""Port parity for evaluation: the KITTI AP (native matcher and its Python
twin, both golden files), the prediction writer, and eval_one_epoch on the
tiny pillar config of tests/test_cli.py against the JAX package's, with
weights carried across by params_from_jax."""
import json
import logging
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import test_kitti_eval as jke
from dfu3d_tpu.core.voxel import VoxelGrid as JVoxelGrid
from dfu3d_tpu.data import build_dataloader as j_build_dataloader
from dfu3d_tpu.data.dataset import BatchMeta as JBatchMeta
from dfu3d_tpu.data.kitti_dataset import KittiDataset as JKittiDataset
from dfu3d_tpu.eval import kitti_eval as jeval
from dfu3d_tpu.models import build_network as j_build_network
from dfu3d_tpu.train.eval_utils import eval_one_epoch as j_eval_one_epoch
from dfu3d_tpu.train.train_state import TrainState
from dfu3d_tpu.utils.config import CfgDict as JCfgDict
from dfu3d_tpu.utils.config import cfg_from_yaml_file as j_cfg_from_yaml_file
from dfu3d_tpu_torch.convert import params_from_jax
from dfu3d_tpu_torch.data import kitti_synthetic
from dfu3d_tpu_torch.data.dataset import BatchMeta
from dfu3d_tpu_torch.data.kitti_dataset import KittiDataset
from dfu3d_tpu_torch.data.loader import build_dataloader
from dfu3d_tpu_torch.eval import kitti_eval as peval
from dfu3d_tpu_torch.eval import native
from dfu3d_tpu_torch.tools.common import build_model
from dfu3d_tpu_torch.train.eval_utils import eval_one_epoch
from dfu3d_tpu_torch.utils.config import CfgDict, cfg_from_yaml_file

from test_cli import _write_cfg
from test_torch_port_models import numpy_variables

CLASSES = ["Car", "Pedestrian"]
GOLDEN = Path(__file__).parent / "golden"
AP_TOL = 1e-6   # the same overlaps and matcher: only float rounding may differ


def random_frames(seed, n_frames=12, classes=("Car", "Pedestrian")):
    """test_kitti_eval-style frames: gt, and detections that jitter most gt
    and add false positives, some of them short in the image (ignored by
    difficulty) or DontCare."""
    rng = np.random.RandomState(seed)
    gt_annos, dt_annos = [], []
    for _ in range(n_frames):
        n = rng.randint(3, 10)
        names, locs, dims, rys = jke._rand_frame(rng, n, classes)
        heights = rng.uniform(20, 120, n)
        bboxes = np.stack([np.full(n, 100.0), np.full(n, 100.0), np.full(n, 200.0),
                           100.0 + heights], axis=1)
        names = [("DontCare" if rng.uniform() < 0.1 else nm) for nm in names]
        gt_annos.append(jke._anno(names, locs, dims, rys, bboxes=bboxes,
                                  trunc=rng.uniform(0, 0.4, n), occ=rng.randint(0, 3, n),
                                  alphas=rng.uniform(-np.pi, np.pi, n)))
        keep = rng.uniform(0, 1, n) > 0.2
        nfp = rng.randint(0, 5)
        fnames, flocs, fdims, frys = jke._rand_frame(rng, nfp, classes)
        k = keep.sum() + nfp
        dt_annos.append(jke._anno(
            [nm for nm, kk in zip(names, keep) if kk] + list(fnames),
            np.concatenate([locs[keep] + rng.normal(0, 0.2, (keep.sum(), 3)), flocs]),
            np.concatenate([dims[keep] * rng.uniform(0.9, 1.1, (keep.sum(), 3)), fdims]),
            np.concatenate([rys[keep] + rng.normal(0, 0.1, keep.sum()), frys]),
            bboxes=np.concatenate([bboxes[keep], np.tile([[100.0, 100, 200, 160]], (nfp, 1))]),
            scores=rng.uniform(0.1, 1.0, k), alphas=rng.uniform(-np.pi, np.pi, k)))
    return gt_annos, dt_annos


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_official_eval_matches_jax(seed):
    gt_annos, dt_annos = random_frames(seed)
    got_str, got = peval.get_official_eval_result(gt_annos, dt_annos, CLASSES)
    want_str, want = jeval.get_official_eval_result(gt_annos, dt_annos, CLASSES)
    assert got.keys() == want.keys() and got_str == want_str
    for k in want:
        assert abs(got[k] - want[k]) <= AP_TOL, (k, got[k], want[k])
    assert 0 < got["Car_3d/moderate_R40"] < 100 and "Car_aos/easy_R40" in got


def test_native_matcher_equals_its_python_twin():
    gt_annos, dt_annos = random_frames(5, n_frames=8, classes=("Car", "Pedestrian", "Van"))
    overlaps_ok = 0
    for metric in (0, 1, 2):
        native_pr = peval.eval_class(gt_annos, dt_annos, [0, 8], (0, 1, 2), metric,
                                     np.full((3, 3, 2), 0.5), compute_aos=metric == 0,
                                     use_native=True)
        python_pr = peval.eval_class(gt_annos, dt_annos, [0, 8], (0, 1, 2), metric,
                                     np.full((3, 3, 2), 0.5), compute_aos=metric == 0,
                                     use_native=False)
        for key in ("recall", "precision", "orientation"):
            np.testing.assert_array_equal(native_pr[key], python_pr[key], err_msg=key)
        overlaps_ok += int(native_pr["precision"].max() > 0)
    assert overlaps_ok == 3


@pytest.mark.parametrize("golden", ["kitti_eval_golden.json",
                                    "kitti_eval_reference_golden.json"])
@pytest.mark.parametrize("use_native", [True, False], ids=["native", "python"])
def test_golden_files(golden, use_native):
    gt_annos, dt_annos = jke.TestGolden()._make_case()
    _, ret = peval.get_official_eval_result(gt_annos, dt_annos, CLASSES, use_native=use_native)
    want = json.loads((GOLDEN / golden).read_text())
    assert set(ret) == set(want)
    for k in want:
        assert abs(round(float(ret[k]), 6) - want[k]) < 1e-6, (k, ret[k], want[k])


def test_native_build_failure_raises(monkeypatch, tmp_path):
    broken = tmp_path / "kitti_match.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.get_lib()
    gt_annos, dt_annos = random_frames(0, n_frames=2)
    with pytest.raises(RuntimeError):
        peval.get_official_eval_result(gt_annos, dt_annos, CLASSES)
    _, ret = peval.get_official_eval_result(gt_annos, dt_annos, CLASSES, use_native=False)
    assert "Car_3d/easy_R40" in ret


@pytest.fixture(scope="module")
def eval_root(tmp_path_factory):
    """A synthetic root with the JAX package's infos (4 val frames), the
    tiny config for both packages, and the loader's datasets."""
    root = tmp_path_factory.mktemp("kitti_port_eval")
    kitti_synthetic.write_root(root, 2, 4, CLASSES, seed=7, num_points=(800, 1200),
                               num_boxes=(4, 7), near_cars=3)
    cfg_dir = tmp_path_factory.mktemp("cfg")
    cfg_file = _write_cfg(root, cfg_dir)
    jcfg = j_cfg_from_yaml_file(cfg_file, JCfgDict())
    from dfu3d_tpu.data.kitti_dataset import create_kitti_infos as j_create_kitti_infos

    j_create_kitti_infos(jcfg.DATA_CONFIG, CLASSES, root, root)
    return root, jcfg, cfg_from_yaml_file(cfg_file, CfgDict())


def test_prediction_writer_matches_jax(eval_root, tmp_path):
    """GT fed back as predictions through both writers: the same annos and
    the same txts."""
    root, jcfg, pcfg = eval_root
    pds = KittiDataset(pcfg.DATA_CONFIG, CLASSES, training=False, root_path=root)
    jds = JKittiDataset(jcfg.DATA_CONFIG, CLASSES, training=False, root_path=root)
    rng = np.random.RandomState(0)
    preds = [{"pred_boxes": info["annos"]["gt_boxes_lidar"] + rng.normal(0, 0.05, (
                  len(info["annos"]["gt_boxes_lidar"]), 7)),
              "pred_scores": rng.uniform(0.3, 1, len(info["annos"]["name"])),
              "pred_labels": np.array([CLASSES.index(n) + 1 for n in info["annos"]["name"]])}
             for info in pds.kitti_infos]
    preds.append({"pred_boxes": np.zeros((0, 7)), "pred_scores": np.zeros(0),
                  "pred_labels": np.zeros(0, np.int64)})
    ids = [info["point_cloud"]["lidar_idx"] for info in pds.kitti_infos] + ["000000"]
    shapes = [info["image"]["image_shape"] for info in pds.kitti_infos] + [None]
    got = pds.generate_prediction_dicts(BatchMeta(ids, [pds.get_calib(i) for i in ids], shapes),
                                        preds, CLASSES, output_path=tmp_path / "p")
    want = jds.generate_prediction_dicts(
        JBatchMeta(ids, [jds.get_calib(i) for i in ids], shapes), preds, CLASSES,
        output_path=tmp_path / "j")
    from test_torch_port_data import assert_tree_equal

    assert_tree_equal(got, want)
    for name in sorted(p.name for p in (tmp_path / "j").iterdir()):
        assert (tmp_path / "p" / name).read_text() == (tmp_path / "j" / name).read_text()
    result_str, ap = pds.evaluation(got[:-1], CLASSES)
    assert ap["Car_bev/moderate_R40"] > 0 and result_str == jds.evaluation(want[:-1],
                                                                            CLASSES)[0]


def test_eval_one_epoch_matches_jax(eval_root, tmp_path):
    """The whole eval epoch on the same weights (fp32 on both sides, one
    loader worker, np.random seeded before each side for the point shuffle):
    equal recall counters and frame order, kept boxes within 1e-4 as sets,
    and every AP within AP_TOL (the boxes agree far inside any IoU
    threshold's reach)."""
    root, jcfg, pcfg = eval_root
    for cfg in (jcfg, pcfg):   # up to 64 boxes per frame; low recall thresholds
        cfg.MODEL.DENSE_HEAD.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE = 64
        cfg.MODEL.POST_PROCESSING.RECALL_THRESH_LIST = [0.01, 0.1, 0.3]
    jgrid = JVoxelGrid.create(jcfg.DATA_CONFIG.POINT_CLOUD_RANGE, [0.4, 0.4, 4.0])
    jmodel = j_build_network(jcfg.MODEL, CLASSES, jgrid, dtype=jnp.float32)
    jds, jloader = j_build_dataloader(jcfg.DATA_CONFIG, CLASSES, batch_size=2, workers=1,
                                      training=False)
    jbatch, _ = next(iter(jloader))
    variables = numpy_variables(
        lambda: jmodel.init({"params": jax.random.PRNGKey(0)}, jbatch, train=False,
                            method=lambda m, b, train: m._features(b, train)),
        seed=3, gains={"vfe/pfn_0/Dense_0/kernel": 0.3,
                       "dense_head/fused_heads/out/kernel": 0.4})
    # car-sized boxes at the cars' height, so that NMS suppresses and
    # recall counts: the fused out conv gives each branch of the one head
    # (center, center_z, dim, rot, hm) 3 channels; dim decodes as exp
    out_bias = np.array(variables["params"]["dense_head"]["fused_heads"]["out"]["bias"])
    out_bias[3] = -0.9
    out_bias[6:9] = np.log([4.6, 1.9, 1.7])
    variables["params"]["dense_head"]["fused_heads"]["out"]["bias"] = out_bias
    state = TrainState(jnp.zeros((), jnp.int32), variables["params"],
                       variables["batch_stats"], None)
    model = build_model(pcfg, "test", "cpu")
    params_from_jax(variables, model)
    pds, ploader = build_dataloader(pcfg.DATA_CONFIG, CLASSES, batch_size=2, workers=1,
                                    training=False)
    logger = logging.getLogger("test_torch_port_eval")

    np.random.seed(0)
    want_str, want, want_annos = j_eval_one_epoch(jmodel, state, jds, jloader, jcfg, logger,
                                                  result_dir=tmp_path / "j", save_to_file=True)
    np.random.seed(0)
    got_str, got, got_annos = eval_one_epoch(model, pds, ploader, pcfg, logger,
                                             result_dir=tmp_path / "p", save_to_file=True,
                                             device="cpu")
    for t in (0.01, 0.1, 0.3):
        assert got[f"recall/rcnn_{t}"] == want[f"recall/rcnn_{t}"]
    assert got["gt_num"] > 0 and got["recall_rcnn_0.01"] > 0 and got["num_frames"] == 4
    assert [a["frame_id"] for a in got_annos] == [a["frame_id"] for a in want_annos]
    for g, w in zip(got_annos, want_annos):
        assert len(g["name"]) == len(w["name"]) > 0
        rows_g = np.concatenate([g["boxes_lidar"], g["score"][:, None]], 1)
        rows_w = np.concatenate([w["boxes_lidar"], w["score"][:, None]], 1)
        dist = np.abs(rows_g[:, None] - rows_w[None]).max(-1)
        match = dist.argmin(0)
        assert len(set(match.tolist())) == len(match)
        assert dist[match, np.arange(len(match))].max() <= 1e-4
        assert (g["name"][match] == w["name"]).all()
    ap_keys = [k for k in want if "_R40" in k]
    assert ap_keys and {k for k in got if "_R40" in k} == set(ap_keys)
    for k in ap_keys:
        assert abs(got[k] - want[k]) <= AP_TOL, (k, got[k], want[k])
    assert len(list((tmp_path / "p" / "final_result" / "data").glob("*.txt"))) == 4
    assert set(got) >= {"time/data", "time/eval_steps", "time/prediction_writer",
                        "time/evaluation", "sec_per_example"}
