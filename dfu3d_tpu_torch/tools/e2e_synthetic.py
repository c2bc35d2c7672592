"""The whole DFU3D chain on a synthetic dataset, with a recorded AP (port of
the JAX package's tools/e2e_synthetic.py). Runs the four pipelines through
the port's own CLIs, in process through their `main(argv)` with the argv
the JAX script gives its subprocesses (plus --device and --dtype):

  1. synthesize a KITTI-format dataset (LiDAR + camera + depth + SEEM
     artifacts + ground-truth labels)             [pseudo.synthetic]
  2. generate pseudo boxes + densified clouds     [tools.generate_pseudo_boxes]
  3. build info pkls: train <- PSEUDO labels, val <- GT labels
  4. train CenterPoint (pillar, or voxel: MeanVFE + VoxelBackBone8x) on the
     pseudo boxes                                 [tools.train]
  5. evaluate on the GT val split -> KITTI AP     [tools.test]

then --evolve_rounds self-evolution rounds: predict on the train split,
keep the boxes scoring at least --evolve_thresh (relaxed to the 70th
percentile of the scores, at least 0.1, when none reaches it), rebuild the
infos and gt database from them, retrain, re-evaluate.

    python -m dfu3d_tpu_torch.tools.e2e_synthetic [--workdir output/e2e_synthetic] [--epochs 12] \\
        [--n_train 64] [--n_val 16] [--device cuda|cpu] [--dtype bfloat16|float32] \\
        [--model pillar|voxel] [--classes Car,Pedestrian,Cyclist] \\
        [--evolve_rounds N] [--skip_initial --start_refine R]

Prints FACTORY_QUALITY, one JSON line with the initial AP and one per round
with the AP history, then SECONDS, the host-clock split of each step.
Checkpoints and prediction directories are picked by epoch number (the JAX
script sorts their names, so epoch 9 comes after epoch 12 there).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
from pathlib import Path

import numpy as np
import yaml

from ..data.kitti_dataset import KittiDataset, create_kitti_infos
from ..data.kitti_io import get_objects_from_label
from ..data.np_geometry import pairwise_iou_bev
from ..device import resolve_device
from ..pseudo.synthetic import make_dataset
from ..train.checkpoint import list_checkpoints
from ..utils.config import CfgDict
from . import generate_pseudo_boxes
from . import test as test_cli
from . import train as train_cli
from .common import newest_epoch_dir

SCORE_COLUMN = 15        # a KITTI prediction line's score
RELAX_PERCENTILE = 70.0  # the weak-model relaxation: keep the top 30 % ...
RELAX_FLOOR = 0.1        # ... at a threshold of at least 0.1


def head_groups(class_names):
    """CLASS_NAMES_EACH_HEAD: vehicles and VRUs in separate grouped heads
    (the reference's per-head class grouping, centerpoint yaml CLASS_NAMES_
    EACH_HEAD) — exercises multi-head target assignment + multi-class NMS."""
    vru = [c for c in class_names if c in ("Pedestrian", "Cyclist")]
    veh = [c for c in class_names if c not in vru]
    return [g for g in (veh, vru) if g]


def build_cfg(root: Path, workdir: Path, batch_size=8, model="pillar",
              class_names=("Car",)):
    """The synthetic run's config, written to workdir/cfgs/synthetic/; the
    same dict as the JAX script's."""
    class_names = list(class_names)
    pcr = [0.0, -25.6, -5.0, 51.2, 25.6, 3.0]
    cfg = {
        "CLASS_NAMES": class_names,
        "DATA_CONFIG": {
            "DATASET": "KittiDataset",
            "DATA_PATH": str(root),
            "POINT_CLOUD_RANGE": pcr,
            "DATA_SPLIT": {"train": "train", "test": "val"},
            "INFO_PATH": {"train": ["kitti_infos_train.pkl"],
                          "test": ["kitti_infos_val.pkl"]},
            "LABEL_DIR": "label_train",
            "GET_ITEM_LIST": ["points"],
            "FOV_POINTS_ONLY": True,
            "MAX_POINTS_PER_FRAME": 40960,
            "MAX_GT_PER_FRAME": 64,
            "DATA_AUGMENTOR": {
                "DISABLE_AUG_LIST": ["placeholder"],
                "AUG_CONFIG_LIST": [
                    {"NAME": "gt_sampling",
                     "DB_INFO_PATH": ["kitti_dbinfos_train.pkl"],
                     "PREPARE": {"filter_by_min_points":
                                 [f"{c}:5" for c in class_names]},
                     "SAMPLE_GROUPS": [
                         f"{c}:{8 if c == 'Car' else 4}" for c in class_names
                     ],
                     "NUM_POINT_FEATURES": 4,
                     "LIMIT_WHOLE_SCENE": True},
                    {"NAME": "random_world_flip", "ALONG_AXIS_LIST": ["x"]},
                    {"NAME": "random_world_rotation",
                     "WORLD_ROT_ANGLE": [-0.3926, 0.3926]},
                    {"NAME": "random_world_scaling",
                     "WORLD_SCALE_RANGE": [0.95, 1.05]},
                ],
            },
            "POINT_FEATURE_ENCODING": {
                "encoding_type": "absolute_coordinates_encoding",
                "used_feature_list": ["x", "y", "z", "intensity"],
                "src_feature_list": ["x", "y", "z", "intensity"],
            },
            "DATA_PROCESSOR": [
                {"NAME": "mask_points_and_boxes_outside_range",
                 "REMOVE_OUTSIDE_BOXES": True},
                {"NAME": "shuffle_points",
                 "SHUFFLE_ENABLED": {"train": True, "test": False}},
                {"NAME": "transform_points_to_voxels_placeholder",
                 "VOXEL_SIZE": [0.2, 0.2, 8.0]},
            ],
        },
        "MODEL": {
            "NAME": "CenterPoint",
            "VFE": {"NAME": "DynPillarVFE", "WITH_DISTANCE": False,
                    "USE_ABSLOTE_XYZ": True, "USE_NORM": True,
                    "NUM_FILTERS": [32, 64]},
            "MAP_TO_BEV": {"NAME": "PointPillarScatter", "NUM_BEV_FEATURES": 64},
            "BACKBONE_2D": {"NAME": "BaseBEVBackbone",
                            "LAYER_NUMS": [3, 5], "LAYER_STRIDES": [2, 2],
                            "NUM_FILTERS": [64, 128],
                            "UPSAMPLE_STRIDES": [1, 2],
                            "NUM_UPSAMPLE_FILTERS": [64, 64]},
            "DENSE_HEAD": {
                "NAME": "CenterHead", "CLASS_AGNOSTIC": False,
                "CLASS_NAMES_EACH_HEAD": head_groups(class_names),
                "SHARED_CONV_CHANNEL": 64, "USE_BIAS_BEFORE_NORM": True,
                "NUM_HM_CONV": 2,
                "SEPARATE_HEAD_CFG": {
                    "HEAD_ORDER": ["center", "center_z", "dim", "rot"],
                    "HEAD_DICT": {
                        "center": {"out_channels": 2, "num_conv": 2},
                        "center_z": {"out_channels": 1, "num_conv": 2},
                        "dim": {"out_channels": 3, "num_conv": 2},
                        "rot": {"out_channels": 2, "num_conv": 2},
                    },
                },
                "TARGET_ASSIGNER_CONFIG": {"FEATURE_MAP_STRIDE": 2,
                                           "NUM_MAX_OBJS": 64,
                                           "GAUSSIAN_OVERLAP": 0.1,
                                           "MIN_RADIUS": 2},
                "LOSS_CONFIG": {"LOSS_WEIGHTS": {"cls_weight": 1.0,
                                                 "loc_weight": 0.25,
                                                 "code_weights": [1.0] * 8}},
                "POST_PROCESSING": {
                    "SCORE_THRESH": 0.1,
                    "POST_CENTER_LIMIT_RANGE": [-10, -30, -10, 60, 30, 10],
                    "MAX_OBJ_PER_SAMPLE": 64,
                    "NMS_CONFIG": {"MULTI_CLASSES_NMS": True,
                                   "NMS_TYPE": "nms_gpu", "NMS_THRESH": 0.2,
                                   "NMS_PRE_MAXSIZE": 256,
                                   "NMS_POST_MAXSIZE": 32},
                },
            },
            "POST_PROCESSING": {"RECALL_THRESH_LIST": [0.3, 0.5, 0.7],
                                "EVAL_METRIC": "kitti"},
        },
        "OPTIMIZATION": {"BATCH_SIZE_PER_GPU": batch_size, "NUM_EPOCHS": 12,
                         "OPTIMIZER": "adam_onecycle", "LR": 0.003,
                         "WEIGHT_DECAY": 0.01, "MOMS": [0.95, 0.85],
                         "PCT_START": 0.4, "DIV_FACTOR": 10,
                         "GRAD_NORM_CLIP": 10},
    }
    if model == "voxel":
        # sparse voxel CenterPoint (MeanVFE + VoxelBackBone8x): exercises
        # the sparse-conv path end-to-end, same head/eval contract
        cfg["DATA_CONFIG"]["DATA_PROCESSOR"][-1] = {
            "NAME": "transform_points_to_voxels_placeholder",
            "VOXEL_SIZE": [0.1, 0.1, 0.2],
            # synthetic frames occupy ~28k voxels at this grid — cap above
            # that or dynamic_voxelize truncates an angular sector of the
            # scene (first-seen cells win) and AP collapses
            "MAX_NUMBER_OF_VOXELS": {"train": 32000, "test": 32000},
        }
        cfg["MODEL"]["VFE"] = {"NAME": "MeanVFE"}
        cfg["MODEL"]["BACKBONE_3D"] = {"NAME": "VoxelBackBone8x"}
        cfg["MODEL"]["MAP_TO_BEV"] = {"NAME": "HeightCompression",
                                      "NUM_BEV_FEATURES": 384}
        cfg["MODEL"]["BACKBONE_2D"]["LAYER_STRIDES"] = [1, 2]
        cfg["MODEL"]["DENSE_HEAD"]["TARGET_ASSIGNER_CONFIG"][
            "FEATURE_MAP_STRIDE"] = 8
    cfg_dir = workdir / "cfgs" / "synthetic"
    cfg_dir.mkdir(parents=True, exist_ok=True)
    stem = ("centerpoint_synthetic" if model == "pillar"
            else f"centerpoint_synthetic_{model}")
    if len(class_names) > 1:
        stem += f"_{len(class_names)}c"
    cfg_file = cfg_dir / f"{stem}.yaml"
    cfg_file.write_text(yaml.safe_dump(cfg))
    return cfg_file


def factory_quality(root: Path, class_names, iou_thresh=0.5):
    """Per-class precision/recall of the pseudo-label factory vs the
    generator's GT (BEV IoU ≥ iou_thresh, camera-frame x/z plane — both label
    sets share the KITTI camera frame so no calib round-trip is needed),
    recorded beside the AP trajectory."""
    def cam_bev(objs, cls):
        rows = [
            [o.loc[0], o.loc[2], 0.0, o.l, o.w, 1.0, -o.ry]
            for o in objs if o.cls_type == cls
        ]
        return np.asarray(rows, np.float32).reshape(-1, 7)

    stats = {c: {"tp": 0, "fp": 0, "fn": 0} for c in class_names}
    train_ids = (root / "ImageSets" / "train.txt").read_text().split()
    for idx in train_ids:
        pf = root / "label_train" / f"{idx}.txt"
        gf = root / "label_2" / f"{idx}.txt"
        pred = get_objects_from_label(pf) if pf.exists() else []
        gt = get_objects_from_label(gf) if gf.exists() else []
        for c in class_names:
            pb, gb = cam_bev(pred, c), cam_bev(gt, c)
            if len(pb) == 0:
                stats[c]["fn"] += len(gb)
                continue
            if len(gb) == 0:
                stats[c]["fp"] += len(pb)
                continue
            iou = pairwise_iou_bev(pb, gb)
            # greedy one-to-one matching, best IoU first
            matched_p, matched_g = set(), set()
            for pi, gi in sorted(
                np.ndindex(iou.shape), key=lambda t: -iou[t]
            ):
                if iou[pi, gi] < iou_thresh:
                    break
                if pi in matched_p or gi in matched_g:
                    continue
                matched_p.add(pi)
                matched_g.add(gi)
            stats[c]["tp"] += len(matched_p)
            stats[c]["fp"] += len(pb) - len(matched_p)
            stats[c]["fn"] += len(gb) - len(matched_g)
    out = {}
    for c, s in stats.items():
        prec = s["tp"] / max(s["tp"] + s["fp"], 1)
        rec = s["tp"] / max(s["tp"] + s["fn"], 1)
        out[c] = {"precision": round(prec, 4), "recall": round(rec, 4),
                  **s}
    return out


def _per_class_ap(ap_dict, class_names):
    """{class: 3d moderate R40 AP} from an AP_DICT."""
    return {c: float(ap_dict.get(f"{c}_3d/moderate_R40", 0.0))
            for c in class_names}


def newest_checkpoint(ckpt_dir) -> Path:
    """The checkpoint of the highest epoch number under ckpt_dir."""
    ckpts = list_checkpoints(ckpt_dir)
    if not ckpts:
        raise FileNotFoundError(f"no checkpoint_epoch_*.pth under {ckpt_dir}")
    return ckpts[-1][1]


def filter_round(pred_dir: Path, frames, label_dir: Path, thresh: float, tag="refine"):
    """Self-evolution's label step: each frame's predicted KITTI lines that
    score at least `thresh` (column 15) go to label_dir/<frame>.txt. When no
    box reaches `thresh`, the threshold drops to the 70th percentile of all
    scores, at least 0.1, so that an undertrained round still emits labels.
    Raises when no box survives (the next round would train on none).
    Returns {"kept", "total", "thresh"}."""
    label_dir.mkdir(exist_ok=True)
    per_frame, all_scores = {}, []
    for txt in frames:
        src = pred_dir / f"{txt}.txt"
        lines = [line for line in (src.read_text().splitlines() if src.exists() else [])
                 if len(line.split()) > SCORE_COLUMN]
        per_frame[txt] = lines
        all_scores.extend(float(line.split()[SCORE_COLUMN]) for line in lines)
    if all_scores and max(all_scores) < thresh:
        relaxed = max(RELAX_FLOOR, float(np.percentile(all_scores, RELAX_PERCENTILE)))
        print(f"[evolve {tag}] no boxes ≥ {thresh}; relaxed threshold to {relaxed:.3f}",
              flush=True)
        thresh = relaxed
    kept = total = 0
    for txt in frames:
        keep = [line for line in per_frame[txt] if float(line.split()[SCORE_COLUMN]) >= thresh]
        kept += len(keep)
        total += len(per_frame[txt])
        (label_dir / f"{txt}.txt").write_text("\n".join(keep) + "\n")
    print(f"[evolve {tag}] kept {kept}/{total} boxes ≥ {thresh}", flush=True)
    if kept == 0:
        raise RuntimeError(f"evolve {tag}: no predictions survived filtering — the model is "
                           "too weak to self-train; increase --epochs or lower --evolve_thresh")
    return {"kept": kept, "total": total, "thresh": thresh}


def build_infos(full_cfg, class_names, root: Path, label_dir: str, split: str,
                gt_database: bool):
    """kitti_infos_<split>.pkl from label_dir and, with gt_database, the gt
    database of the train split, as the JAX script builds them."""
    ds_cfg = CfgDict(full_cfg["DATA_CONFIG"])
    ds_cfg["LABEL_DIR"] = label_dir
    create_kitti_infos(ds_cfg, class_names, root, root, splits=(split,))
    if gt_database:
        ds = KittiDataset(ds_cfg, class_names, training=False, root_path=root)
        ds.set_split("train")
        ds.create_groundtruth_database(root / "kitti_infos_train.pkl", root,
                                       used_classes=class_names, split="train")


@contextlib.contextmanager
def working_dir(path: Path):
    """The CLIs write output/ under the working directory, as the JAX
    script's subprocesses do with cwd=workdir."""
    cwd = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(cwd)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="dfu3d_tpu_torch synthetic end-to-end run")
    ap.add_argument("--workdir", type=str, default="output/e2e_synthetic",
                    help="dataset, configs and outputs (default under the working "
                         "directory; an existing dataset there is reused)")
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--n_train", type=int, default=64)
    ap.add_argument("--n_val", type=int, default=16)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device; the card unless 'cpu' is asked for")
    ap.add_argument("--dtype", type=str, default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--evolve_rounds", type=int, default=0,
                    help="self-evolution refine rounds after the initial "
                         "train (predict@thresh → rebuild infos → retrain)")
    ap.add_argument("--evolve_thresh", type=float, default=0.5)
    ap.add_argument("--skip_initial", action="store_true",
                    help="reuse an existing workdir's initial training "
                         "(steps 1-5) and go straight to the evolve rounds")
    ap.add_argument("--model", type=str, default="pillar", choices=["pillar", "voxel"],
                    help="the flagship pillar CenterPoint or the sparse voxel "
                         "variant (MeanVFE + VoxelBackBone8x)")
    ap.add_argument("--start_refine", type=int, default=0,
                    help="first refine-round index (with --skip_initial, "
                         "resumes from refine{start_refine-1}'s checkpoint "
                         "when that round exists)")
    ap.add_argument("--classes", type=str, default="Car",
                    help="comma-separated class list, e.g. Car,Pedestrian,Cyclist")
    return ap.parse_args(argv)


def main(argv=None):
    """Run; returns {"result": the initial AP record, "factory_quality",
    "rounds": [per refine round: its record, filter stats, the CLIs' results
    and timings], "ap_history", "seconds": the initial chain's host-clock
    split, "train" and "eval": the initial train and test CLIs' results}."""
    args = parse_args(argv)
    resolve_device(args.device)
    class_names = args.classes.split(",")
    workdir = Path(args.workdir).resolve()
    root = workdir / "data"
    seconds = {}

    # 1. dataset
    t0 = time.perf_counter()
    if not (root / "ImageSets" / "train.txt").exists():
        print("[1/5] synthesizing dataset ...", flush=True)
        make_dataset(root, n_train=args.n_train, n_val=args.n_val, class_names=class_names)
    else:
        print("[1/5] dataset exists, reusing", flush=True)
    seconds["dataset"] = time.perf_counter() - t0

    cfg_file = build_cfg(root, workdir, batch_size=args.batch_size, model=args.model,
                         class_names=class_names)
    full_cfg = yaml.safe_load(cfg_file.read_text())
    rel_cfg = str(cfg_file.relative_to(workdir))
    out_dir = workdir / "output" / "synthetic" / cfg_file.stem / "default"
    run = dict(args=args, workdir=workdir, root=root, rel_cfg=rel_cfg, full_cfg=full_cfg,
               class_names=class_names,
               device=["--device", args.device, "--dtype", args.dtype])

    if args.skip_initial:
        prev_dir = out_dir
        if args.start_refine > 0:
            cand = (workdir / "output" / "synthetic" / cfg_file.stem
                    / f"refine{args.start_refine - 1}")
            if (cand / "ckpt").exists():
                prev_dir = cand
        ckpt = newest_checkpoint(prev_dir / "ckpt")
        result = {"value": float("nan"), "detail": "skipped (reused workdir)"}
        print(f"[skip_initial] reusing {ckpt}", flush=True)
        rounds = _run_evolve(run, ckpt, result)
        return {"result": result, "factory_quality": None, "rounds": rounds,
                "ap_history": [result["value"]] + [r["value"] for r in rounds],
                "seconds": seconds, "train": None, "eval": None}

    # 2. pseudo boxes (train split frames only need them, but run on all)
    print("[2/5] generating pseudo boxes ...", flush=True)
    t0 = time.perf_counter()
    generate_pseudo_boxes.main(["--detpath", str(root), "--ground_z", "-1.7", "--z_offset",
                                "0.0", "--classes", args.classes, "--device", args.device])
    seconds["pseudo_boxes"] = time.perf_counter() - t0
    labels = list((root / "label_train").glob("*.txt"))
    n_lines = sum(len(p.read_text().splitlines()) for p in labels)
    print(f"      pseudo boxes written: {n_lines} across {len(labels)} frames", flush=True)
    fq = factory_quality(root, class_names)
    print("FACTORY_QUALITY " + json.dumps(fq), flush=True)

    # 3. infos: train ← pseudo labels, val ← GT
    print("[3/5] building infos ...", flush=True)
    t0 = time.perf_counter()
    build_infos(full_cfg, class_names, root, full_cfg["DATA_CONFIG"]["LABEL_DIR"], "train",
                gt_database=True)
    build_infos(full_cfg, class_names, root, "label_2", "val", gt_database=False)
    seconds["infos"] = time.perf_counter() - t0

    # 4. train on pseudo labels
    print("[4/5] training ...", flush=True)
    t0 = time.perf_counter()
    with working_dir(workdir):
        trained = train_cli.main(["--cfg_file", rel_cfg, "--epochs", str(args.epochs),
                                  "--workers", "2", *run["device"]])
    seconds["train"] = time.perf_counter() - t0
    ckpt = newest_checkpoint(out_dir / "ckpt")

    # 5. eval against GT
    print("[5/5] evaluating ...", flush=True)
    t0 = time.perf_counter()
    with working_dir(workdir):
        ((_, _, ap_dict),) = test_cli.main(["--cfg_file", rel_cfg, "--ckpt", str(ckpt),
                                            "--workers", "2", *run["device"]])
    seconds["eval"] = time.perf_counter() - t0
    per_class = _per_class_ap(ap_dict, class_names)
    m = {k: v for k, v in ap_dict.items()
         if any(f"{c}_3d" in k or f"{c}_bev" in k for c in class_names)}
    result = {
        "metric": "synthetic_e2e_ap3d_moderate_R40",
        "value": float(np.mean(list(per_class.values()))),
        "unit": "AP (mean over classes)",
        "per_class": per_class,
        "detail": {k: float(v) for k, v in m.items()},
        "protocol": "trained on factory pseudo-labels only, eval vs GT",
        "epochs": args.epochs,
        "frames": {"train": args.n_train, "val": args.n_val},
        "factory_quality": fq,
    }
    print(json.dumps(result), flush=True)

    rounds = _run_evolve(run, ckpt, result)
    print("SECONDS " + json.dumps({"initial": seconds,
                                   "rounds": [r["seconds"] for r in rounds]}), flush=True)
    return {"result": result, "factory_quality": fq, "rounds": rounds,
            "ap_history": [result["value"]] + [r["value"] for r in rounds],
            "seconds": seconds, "train": trained, "eval": ap_dict}


def _run_evolve(run, ckpt, result):
    """Self-evolution refine rounds (train → predict on the train split at
    the threshold → rebuild infos from the refined labels → retrain from
    scratch → re-eval; the reference's initial/refine0/refine1 workflow).
    Returns one record per round."""
    args, workdir, root, rel_cfg = run["args"], run["workdir"], run["root"], run["rel_cfg"]
    class_names = run["class_names"]
    stem = Path(rel_cfg).stem
    out_dir = workdir / "output" / "synthetic" / stem / "default"
    ap_history = [result["value"]]
    per_class_history = [result.get("per_class")]
    frames = (root / "ImageSets" / "train.txt").read_text().split()
    records = []
    for r_idx in range(args.start_refine, args.start_refine + args.evolve_rounds):
        tag = f"refine{r_idx}"
        seconds = {}
        print(f"[evolve {tag}] predicting on train split ...", flush=True)
        t0 = time.perf_counter()
        with working_dir(workdir):
            ((epoch, _, predicted),) = test_cli.main([
                "--cfg_file", rel_cfg, "--ckpt", str(ckpt), "--save_to_file", "--eval_tag",
                f"predict_{tag}", "--workers", "2", *run["device"], "--set",
                "DATA_CONFIG.DATA_SPLIT.test", "train",
                "DATA_CONFIG.INFO_PATH.test", "['kitti_infos_train.pkl']"])
        seconds["predict"] = time.perf_counter() - t0
        pred_dir = newest_epoch_dir(out_dir / "eval", f"train/predict_{tag}/final_result/data")

        # keep confident boxes only (reference 'obtain pseudo boxes'
        # SCORE_THRESH comment, centerpoint yaml:83)
        t0 = time.perf_counter()
        kept = filter_round(pred_dir, frames, root / f"label_{tag}", args.evolve_thresh, tag)
        seconds["filter"] = time.perf_counter() - t0

        print(f"[evolve {tag}] rebuilding infos + gt db ...", flush=True)
        t0 = time.perf_counter()
        build_infos(run["full_cfg"], class_names, root, f"label_{tag}", "train",
                    gt_database=True)
        seconds["rebuild"] = time.perf_counter() - t0

        print(f"[evolve {tag}] retraining ...", flush=True)
        t0 = time.perf_counter()
        with working_dir(workdir):
            trained = train_cli.main(["--cfg_file", rel_cfg, "--epochs", str(args.epochs),
                                      "--extra_tag", tag, "--workers", "2", *run["device"]])
        seconds["train"] = time.perf_counter() - t0
        ckpt = newest_checkpoint(workdir / "output" / "synthetic" / stem / tag / "ckpt")

        print(f"[evolve {tag}] evaluating vs GT ...", flush=True)
        t0 = time.perf_counter()
        with working_dir(workdir):
            ((_, _, ap_dict),) = test_cli.main(["--cfg_file", rel_cfg, "--ckpt", str(ckpt),
                                                "--extra_tag", tag, "--workers", "2",
                                                *run["device"]])
        seconds["eval"] = time.perf_counter() - t0
        per_class = _per_class_ap(ap_dict, class_names)
        ap_r = float(np.mean(list(per_class.values())))
        ap_history.append(ap_r)
        per_class_history.append(per_class)
        record = {"metric": f"synthetic_e2e_ap3d_moderate_R40_{tag}",
                  "value": ap_r, "unit": "AP (mean over classes)",
                  "per_class": per_class, "ap_history": list(ap_history),
                  "per_class_history": list(per_class_history)}
        print(json.dumps(record), flush=True)
        records.append({**record, "predicted_epoch": epoch, "prediction_dir": pred_dir,
                        **kept, "seconds": seconds, "predict": predicted, "train": trained,
                        "eval": ap_dict})
    return records


if __name__ == "__main__":
    main()
