#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (dfu3d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one card

Phases, each fatal on failure:
  1. device   the card's name and power limit (nvidia-smi); TF32 off for the
              fp32 comparisons.
  2. build    every CUDA kernel of the serving paths, from this checkout, one
              nvcc per source, all at once; the host libraries (the KITTI
              matcher, the PNG unfilter) with g++.
  3. kernels  each kernel against its plain PyTorch twin at the paths' shapes
              and at edge cases, timed with CUDA events beside its bound and,
              for the gather-GEMM, the library form (gather + one GEMM). The
              overlap kernel's culled pairs must be exactly 0 in both; its
              bound counts the full arithmetic for overlapping pairs only,
              the all-pairs bound (full arithmetic for every pair) stays
              beside it. The gather-GEMM runs its tensor-core variant in
              bf16 (the nine path shapes; one live tap per row,
              sentinel-only tiles, NaN in masked rows) and its CUDA-core
              variant in fp32.
  4. serve    CenterPoint-pillar (flagship config, 256 x 512 BEV), then voxel
              CenterPoint (cbgs_voxel01_res3d_centerpoint, 1024 x 1024 x 40
              grid), each at full width answering 4 requests through
              eval_batches under bf16 autocast with seeded random weights;
              the kernel launch counts (the gather-GEMM's per variant too)
              are set to 0 just before each path and read just after it:
              the voxel path must run the tensor-core gather-GEMM 21 times
              per batch. Then the 21 gather-GEMM calls and the overlap calls
              (NMS, recall) of one served request per path are each held
              against the plain twin on their own inputs and timed.
  5. check    per path, one request in fp32 through the kernels and through
              their plain twins, its gt made from boxes the serving run kept:
              valid masks, labels and recall counters equal, boxes and scores
              within 1e-4.
  6. train    per model (pillar, then voxel with 10-column gt for its vel
              branch), at full width with seeded weights, 5 steps through
              trainer.train_model (B=4, 60,000 points, 256 gt slots, bf16
              autocast, the config's adam_onecycle over 1000 steps), which
              saves a checkpoint into a temporary directory; the checkpoint
              is reloaded into a fresh model and optimizer and must equal
              them. Per step the loss, grad_norm, host-clock ms and the
              gather-GEMM launches per variant; fatal on a non-finite loss or
              gradient, a parameter or BN buffer left unchanged, or a voxel
              step that does not launch the tensor-core gather-GEMM exactly
              41 times (21 forward, 20 dX). Each of one voxel step's 20 dX
              launches is held against the plain twin on its own inputs and
              timed (kernel, plain, library, bound). Then one fp32 step per
              model through the kernels and through their plain twins from
              the same weights: loss within 1e-5 relative; with the forward
              through the kernels in both (ReLU kinks), every gradient leaf
              within 1e-4 of its largest entry or, where fp32 rounding alone
              moves it more, within 4x what reversing the plain twin's tap
              order moves it.
  7. cli      the flagship from disk through the port's CLIs, in a temporary
              working directory: a synthetic KITTI root (16 train + 8 val
              frames of 40,000-60,000 points in the camera frustum, 20-40
              boxes of the ten classes) laid out for the flagship YAML,
              tools.create_infos, the AP round trip (val gt fed back as
              predictions: Car 3D and BEV easy R40 above 85), the loader's
              frames/s with the config's augmentations at 4 threads beside
              what phase 6's pillar step consumes, tools.train (1 epoch,
              bf16, full width; fatal on a non-finite loss, no checkpoint or
              any kernel launch), tools.test (fatal unless one KITTI txt per
              val frame, every class's 3D moderate R40 in AP_DICT and 2
              overlap launches per eval batch), then the fp32 eval epoch
              through the kernels and through their plain twins: recall
              counters equal, kept boxes within 1e-4 as sets, APs equal. The
              native KITTI matcher is built with g++ in phase 2.
  8. pseudo   pipeline 2 from raw frames, in a temporary directory: a
              synthetic root of 8 make_scene frames (352 x 1216 image, ~35,000
              LiDAR points, 8 Cars, seem/ and depth/ artifacts);
              tools.complete_depth with enet_ref (bf16, seeded weights) into a
              separate directory, so that the factory keeps the scenes' exact
              depth; tools.generate_pseudo_boxes on the card (factory
              defaults): one label txt and one velodyne_depth npy per frame,
              and no B1 or B2 launch; tools.create_infos --label_dir
              label_train --suffix _initial_pseudo_box, whose box count per
              frame must equal the factory's; the BEV recovery of the scenes'
              gt Cars (IoU >= 0.5) at or above PSEUDO_RECALL_MIN; 2 frames
              through the factory on the card and on this machine's CPU with
              the same RANSAC triples (names and counts equal, boxes within
              PSEUDO_BOX_TOL as sets, fused clouds equal; the frame
              program's radius tests stage by stage from the same inputs,
              every differing entry within 1e-5 m of its radius, the bf16
              adjacency exact; differing boxes pass only where such an entry
              explains them); one enet_ref depth map in strict fp32 on the
              card and on the CPU within DEPTH_TOL, and the card's TF32
              reading beside it.
  9. evolve   pipelines 1 and 4, in a temporary working directory:
              tools.nuscenes2kitti on 4 raw-table frames (host only; each car
              read back through the calibration within 5 cm); tools.evolve
              --rounds 1 --epochs 2 on the flagship config over phase 7's
              layout (--score_thresh 0: a model trained 8 steps from scratch
              scores nothing above 0.1), fatal unless the predict pass launches
              B1 twice per eval batch and B2 never, label_refine0 is the newest
              epoch's predictions byte for byte and the rebuilt infos count its
              boxes; tools.e2e_synthetic, pillar, Car,Pedestrian,Cyclist, one
              refine round (synthetic data, pseudo boxes, infos, train, eval,
              then predict, filter, rebuild, retrain, eval), fatal if a class
              is missing from an AP_DICT or the round keeps no box, B1 twice per
              eval batch; one round's predict pass in fp32 through B1 and
              through its plain twin from the same checkpoint, the refined
              label sets equal; tools.e2e_synthetic --model voxel
              --evolve_rounds 0 --epochs 1 (VoxelBackBone8x), fatal unless
              every bf16 train step launches the tensor-core B2 exactly 23
              times (12 forward, 11 dX); each of one served request's 12 B2
              calls and one train step's 11 dX calls held against the plain
              twin and timed (kernel, plain, library, bound).
 10. pointrcnn PointRCNN on DFU3D's second detector config
              (pointrcnn_nuscenes2kitti: PointNet2MSG 4096/1024/256/64, the
              point head, proposal NMS 4096 -> 128 at 0.8, the RoI head) at
              full width with seeded weights, in a temporary working
              directory: phase 7's synthetic root again, its 16 train frames
              read through KittiDataset in test mode (sample_points to
              16,384); 4 requests of B=4 through eval_batches (bf16), fatal
              unless B1 launches exactly 3 times per batch (proposal NMS
              over (4, 4096, 4096), final NMS, recall) and B2 never; where a
              request's time goes (profile_serve's spans: FPS, ball query,
              MLPs per level, B1 and the keep-scan per NMS) with the FPS
              share, keep-scan iterations, device busy and idle; each of one
              request's 3 B1 calls held against the plain twin and timed
              beside its bound; one request in fp32 through B1 and through its
              plain twin (valid masks equal, kept boxes within PATH_TOL);
              tools.test with the config on the val split from a checkpoint of
              the seeded weights: an AP_DICT with the 8 classes, B1 3 times
              per eval batch.
 11. pointrcnn_train  PointRCNN training on the same config at full width
              with seeded weights, in a temporary working directory on
              phase 7's synthetic root again: 5 bf16 steps through
              trainer.train_model (B=4, the train split read in train mode:
              gt sampling and world augmentations, sample_points to 16,384;
              each batch with 16 gt per frame made of the model's proposals
              just before its step, zoo.proposal_gt, so that the RoI head's
              reg branch gets gradient; the config's adam_onecycle over 1000
              steps), per step the loss terms, grad_norm, host-clock ms and
              the kernel launches; fatal on a non-finite loss or gradient, a
              step without a RoI over REG_FG_THRESH (rcnn_reg_loss 0), a
              parameter or BN buffer left unchanged, or a step that does not
              launch B1 exactly twice
              (proposal NMS over (4, 4096, 4096), the RoI targets' 3D IoU over
              (4, 128, G)) or that launches B2; the checkpoint reloaded
              into a fresh model and optimizer must equal them. Each of one
              step's 2 B1 calls held against the plain twin and timed beside
              its bound; one fp32 step through B1 and one through its plain
              twin from the same weights and RoI uniforms (sampled RoIs
              equal, loss within 1e-5 relative, every gradient leaf within
              1e-4 of its largest entry or 4x the card's run-to-run spread);
              where a step's time goes (profile_train's spans: FPS, targets,
              backward, clip + optimizer; busy and idle); tools.train on the
              config for 1 epoch (16 frames, 4 steps, B1 twice per step) and
              tools.test --ckpt of its checkpoint (an AP_DICT with the 8
              classes, B1 3 times per eval batch).
The lines before the last are {"cli": {...}}, {"pseudo": {...}},
{"evolve": {...}}, {"pointrcnn": {...}}, {"pointrcnn_train": {...}} and
{"kernels": [...]}; the last line is {"ok": true, "device": {...}}.
"""
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
RECALL_THRESH = (0.3, 0.5, 0.7)
FP32_PEAK = 67e12      # H100 SXM fp32 outside the tensor cores, FLOP/s
BF16_PEAK = 989e12     # H100 SXM dense bf16 tensor cores, FLOP/s
HBM_RATE = 3.35e12     # H100 SXM device memory, bytes/s
KERNEL_TOL = 1e-3      # m², overlap kernel vs plain
GEMM_TOL = 1e-4        # gather-GEMM kernel vs plain in fp32
PATH_TOL = 1e-4        # boxes and scores, kernel path vs plain path in fp32
SPIN_CYCLES = 2_000_000  # ~1 ms of the card's clock ahead of each timed call
TRAIN_STEPS = 5           # train steps per model in phase 6
TRAIN_TOTAL_STEPS = 1000  # the one-cycle schedule's length, as bench.py's train leg
TRAIN_LOSS_TOL = 1e-5     # relative, fp32 train step through kernels vs plain twins
TRAIN_GRAD_TOL = 1e-4     # of each gradient leaf's largest |entry|
VOXEL_TRAIN_B2 = 41       # tensor-core gather-GEMM launches per voxel train step
CLI_CFG = "cfgs/kitti_models/centerpoint_nuscenes2kitti.yaml"  # from phase 7's work dir
CLI_TRAIN_FRAMES, CLI_VAL_FRAMES = 16, 8
LOADER_WORKERS = 4
AP_ROUND_TRIP_MIN = 85.0  # Car 3D and BEV easy R40, gt fed back as predictions
PSEUDO_FRAMES = 8         # make_scene seeds 0-7
# gt Cars recovered at BEV IoU >= 0.5 over the 8 frames; the JAX factory
# recovers 42 of 64 (0.6562) on the CPU; the floor leaves 3 gt of room for the
# card's own RANSAC draws
# (JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_port_pseudo_cli.py)
PSEUDO_RECALL_MIN = 0.6
PSEUDO_BOX_TOL = 1e-3     # m and rad, the factory on the card vs on the CPU
PSEUDO_STRADDLE = 1e-5    # m, a pair this close to a radius may flip a test
# of the map's largest |depth|, strict fp32 on the card vs the CPU: between
# the fp32 reading (2.58e-6) and what the card's TF32 convolutions read
# (8.87e-4), both on an H100 80GB HBM3 at 700 W, so a TF32 run fails
DEPTH_TOL = 5e-5
# phase 7's fp32 eval epoch through the kernels vs their plain twins: the
# network's outputs repeat bit for bit and B1 enters only NMS's keep
# decisions and the recall counts, so equal kept sets give equal APs
EVAL_AP_TOL = 0.0
NUSC_FRAMES = 4           # phase 9's raw-table nuScenes frames
NUSC_TOL = 0.05           # m, a car read back through the calibration (labels print 2 decimals)
EVOLVE_EPOCHS = 2         # tools.evolve: two checkpoints, so that the newest is a choice
E2E_FRAMES = (32, 8)      # e2e_synthetic pillar: train, val frames
E2E_EPOCHS, E2E_BATCH = 20, 2   # 320 steps: the round keeps boxes at 0.5
VOXEL_E2E_FRAMES, VOXEL_E2E_BATCH = (8, 4), 4
VOXEL8X_TRAIN_B2 = 23     # tensor-core gather-GEMM launches per VoxelBackBone8x train step
VOXEL8X_CONVS = ["conv_input", "conv1", "down2", "conv2a", "conv2b", "down3", "conv3a",
                 "conv3b", "down4", "conv4a", "conv4b", "conv_out"]   # forward order
# the 21 sparse convs of one voxel eval step at B=4, max_voxels 60000:
# (name, V, Q, K, Cin, Cout, launches per step)
GEMM_PATH_SHAPES = [
    ("conv_input", 60000, 60000, 27, 4, 16, 1),
    ("res1", 60000, 60000, 27, 16, 16, 4),
    ("down2", 60000, 30000, 27, 16, 32, 1),
    ("res2", 30000, 30000, 27, 32, 32, 4),
    ("down3", 30000, 15000, 27, 32, 64, 1),
    ("res3", 15000, 15000, 27, 64, 64, 4),
    ("down4", 15000, 7500, 27, 64, 128, 1),
    ("res4", 7500, 7500, 27, 128, 128, 4),
    ("conv_out", 7500, 7500, 3, 128, 128, 1),
]


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


def time_ms(fn, reps=25, warmup=3):
    """Median of `reps` CUDA-event timings of fn()'s device work after
    `warmup` calls. Each timing is enqueued behind a spin kernel
    (torch.cuda._sleep, ~1 ms) so that the host has queued fn()'s launches
    before the card reaches the start event: the host's own time per call
    (Python, ctypes, launch) is not counted unless it exceeds the spin."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def random_boxes(gen, g, n, x_range, y_range, device):
    import torch

    def u(lo, hi, *shape):
        return torch.rand(*shape, generator=gen) * (hi - lo) + lo

    b = torch.stack([u(*x_range, g, n), u(*y_range, g, n), u(-2, 0, g, n),
                     u(0.5, 5, g, n), u(0.5, 5, g, n), u(0.5, 3, g, n),
                     u(-math.pi, math.pi, g, n)], dim=-1)
    return b.to(device)


def overlap_cases(device):
    """Phase 3's overlap problems: name -> (boxes_a, boxes_b)."""
    import torch

    gen = torch.Generator().manual_seed(0)
    cases = {
        # (G, N, M) as the main path gives them: NMS over 6 heads x B=4, and
        # recall of 498 kept slots against 256 gt slots per sample
        "nms": (random_boxes(gen, 24, 500, (0, 40), (-20, 20), device),) * 2,
        "recall": (random_boxes(gen, 4, 498, (0, 50), (-50, 50), device),
                   random_boxes(gen, 4, 256, (0, 50), (-50, 50), device)),
        "ragged": (random_boxes(gen, 1, 150, (-3, 3), (-3, 3), device),
                   random_boxes(gen, 1, 70, (-3, 3), (-3, 3), device)),
        "far": (random_boxes(gen, 2, 150, (57, 63), (-3, 3), device),
                random_boxes(gen, 2, 70, (57, 63), (-3, 3), device)),
    }
    same = random_boxes(gen, 1, 64, (55, 65), (-5, 5), device)
    cases["identical"] = (same, same)
    return cases


def corners(boxes):
    from dfu3d_tpu_torch.core.geometry import boxes as gboxes

    return gboxes.boxes_to_corners_bev(boxes).contiguous()


def overlap_agreement(label, ca, cb, got):
    """The kernel's output against the plain twin's: within KERNEL_TOL, and
    exactly 0 (in both) wherever the cull predicate culls. Fatal on a miss.
    Returns (entry, cull mask)."""
    from dfu3d_tpu_torch.core.geometry import iou_kernel

    want = iou_kernel.overlap_bev_plain(ca, cb)
    culled = iou_kernel.overlap_bev_cull_plain(ca, cb)
    err = (got - want).abs().max().item()
    if not err <= KERNEL_TOL:
        fail(f"overlap kernel vs plain on {label} {tuple(got.shape)}: max |diff| {err}")
    if culled.any() and (got[culled].abs().max().item() != 0.0
                         or want[culled].abs().max().item() != 0.0):
        fail(f"overlap on {label}: a culled pair is not exactly 0 (kernel "
             f"{got[culled].abs().max().item()}, plain {want[culled].abs().max().item()})")
    return {"shape": list(got.shape), "max_abs_err": err}, culled


def time_overlap(entry, ca, cb, got, culled, reps=25):
    """Kernel and plain times beside the bound of what these inputs need:
    the full arithmetic (OPS_PER_PAIR, and >= 3 surviving clipped edges of
    OPS_PER_LIVE_EDGE) for each pair that overlaps, none for the others
    (OPS_PER_PAIR_CULL), against the corners read once and the output
    written once. The bound of the full arithmetic for every pair, as the
    one-thread-per-pair kernel counted it, is kept beside it as
    bound_all_pairs_ms."""
    from dfu3d_tpu_torch.core.geometry import iou_kernel

    pairs = got.numel()
    overlapping = int((got > 0).sum())
    live_ops = 3 * iou_kernel.OPS_PER_LIVE_EDGE * overlapping
    ops = (iou_kernel.OPS_PER_PAIR * overlapping + live_ops
           + iou_kernel.OPS_PER_PAIR_CULL * (pairs - overlapping))
    ops_all = iou_kernel.OPS_PER_PAIR * pairs + live_ops
    nbytes = 4 * (ca.numel() + cb.numel() + got.numel())
    ops_ms, bytes_ms = ops / FP32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    entry.update(
        ms=time_ms(lambda: iou_kernel.overlap_bev(ca, cb), reps=reps),
        plain_ms=time_ms(lambda: iou_kernel.overlap_bev_plain(ca, cb), reps=max(reps // 5, 3)),
        bound_ms=max(ops_ms, bytes_ms), bound_by="operations" if ops_ms >= bytes_ms else "bytes",
        ops=ops, bytes=nbytes, overlapping_pairs=overlapping,
        survivor_share=1.0 - culled.float().mean().item(),
        overlapping_share=overlapping / pairs,
        ops_all_pairs=ops_all, bound_all_pairs_ms=max(ops_all / FP32_PEAK * 1e3, bytes_ms))
    entry["share_of_bound"] = entry["bound_ms"] / entry["ms"]
    return entry


def overlap_line(label, entry):
    return (f"[kernels] overlap {label} {tuple(entry['shape'])}: max |kernel - plain| = "
            f"{entry['max_abs_err']:.3g} m^2"
            + (f", survivors {entry['survivor_share']:.4%}, overlapping "
               f"{entry['overlapping_share']:.4%}, kernel {entry['ms']:.4f} ms, plain "
               f"{entry['plain_ms']:.3f} ms, bound {entry['bound_ms']:.4f} ms "
               f"({entry['bound_by']}, {entry['share_of_bound']:.1%}; all pairs "
               f"{entry['bound_all_pairs_ms']:.4f})" if "ms" in entry else ""))


def check_overlap_kernel(device):
    """Phase 3: the rotated-BEV overlap kernel against its plain twin."""
    import torch

    from dfu3d_tpu_torch.core.geometry import iou_kernel

    per_shape, max_err = [], 0.0
    for name, (a, b) in overlap_cases(device).items():
        ca, cb = corners(a), corners(b)
        got = iou_kernel.overlap_bev(ca, cb)
        torch.cuda.synchronize()
        entry, culled = overlap_agreement(name, ca, cb, got)
        entry = {"case": name, **entry}
        max_err = max(max_err, entry["max_abs_err"])
        if name == "identical":
            area = a[0, :, 3] * a[0, :, 4]
            rel = ((got[0].diagonal() - area).abs() / area).max().item()
            if not rel <= 1e-4:
                fail(f"identical boxes: diagonal differs from dx*dy by {rel} (rel)")
        if name in ("nms", "recall"):
            time_overlap(entry, ca, cb, got, culled)
        per_shape.append(entry)
        log(overlap_line(name, entry))
    return per_shape, max_err


def served_overlap_problems(model, batch, device, names=("nms", "recall")):
    """The overlap calls of one served bf16 request, recorded in order and
    named by `names`: [("nms", corners_a, corners_b), ("recall", ...)] for
    CenterPoint; PointRCNN makes three (proposal NMS, final NMS, recall)."""
    import torch

    from dfu3d_tpu_torch.core.geometry import iou_kernel
    from dfu3d_tpu_torch.train.train_state import make_eval_step

    calls = []
    kernel_fn = iou_kernel.overlap_bev

    def recording(ca, cb):
        calls.append((ca, cb))
        return kernel_fn(ca, cb)

    iou_kernel.overlap_bev = recording
    try:
        make_eval_step(model, RECALL_THRESH, device=device, dtype=torch.bfloat16)(batch)
    finally:
        iou_kernel.overlap_bev = kernel_fn
    torch.cuda.synchronize()
    if len(calls) != len(names):
        fail(f"one served request made {len(calls)} overlap calls, not {len(names)} "
             f"({', '.join(names)})")
    return [(name, ca, cb) for name, (ca, cb) in zip(names, calls)]


def time_served_overlaps(path, model, batch, device, names=("nms", "recall")):
    """Each overlap call of one served request, held against the plain twin
    (fatal on a miss) and timed beside its bound. The plain twin computes a
    large problem in blocks of about 2^20 pairs (rows of A against all of
    B), so (4, 4096, 4096) fits."""
    import torch

    from dfu3d_tpu_torch.core.geometry import iou_kernel

    entries = []
    for name, ca, cb in served_overlap_problems(model, batch, device, names):
        got = iou_kernel.overlap_bev(ca, cb)
        torch.cuda.synchronize()
        entry, culled = overlap_agreement(f"served {path} {name}", ca, cb, got)
        entry = {"path": path, "problem": name, **entry}
        entries.append(time_overlap(entry, ca, cb, got, culled, reps=10))
        log(overlap_line(f"served {path} {name}", entry))
    return entries


def bf16_ulp(x):
    """One bf16 ulp of |x| (8 significant bits), in fp32."""
    import torch

    return torch.exp2(torch.floor(torch.log2(x.abs().float().clamp(min=2.0 ** -126))) - 7)


def gemm_agreement(args, got, want):
    """Kernel output against the plain twin's: fp32 within GEMM_TOL; bf16
    within one bf16 ulp of the plain result plus the largest difference of
    two fp32 sums of K·Cin products taken in another order (2·K·Cin·2^-24
    times the sum of their magnitudes): both round such a sum once."""
    from dfu3d_tpu_torch.core.voxel import gather_gemm_kernel as gk

    feats, valid, nbr, w = args
    k, cin = w.shape[0], w.shape[1]
    err = (got.float() - want.float()).abs()
    entry = {"max_abs_err": err.max().item() if err.numel() else 0.0}
    if feats.dtype.itemsize == 2:
        mag = gk.gather_gemm_plain(feats.abs(), valid, nbr, w.abs()).float()
        ulp = bf16_ulp(want)
        tol = ulp + 2 * k * cin * 2.0 ** -24 * mag
        entry["max_err_in_ulps"] = (err / ulp).max().item() if err.numel() else 0.0
        entry["share_beyond_1ulp"] = (err > ulp).float().mean().item() if err.numel() else 0.0
        entry["ok"] = bool((err <= tol).all())
    else:
        entry["ok"] = entry["max_abs_err"] <= GEMM_TOL
    return entry


def launch_variant(fn):
    """fn()'s result and the gather-GEMM variant it launched."""
    from dfu3d_tpu_torch.core.voxel import gather_gemm_kernel as gk

    before = dict(gk.launches_by_variant)
    out = fn()
    ran = [k for k, n in gk.launches_by_variant.items() if n != before[k]]
    return out, ran[0] if len(ran) == 1 else ran


def gemm_costs(feats, valid, nbr, w):
    """(operations, bytes, live taps) of one gather-GEMM on these inputs:
    2·Cin·Cout per tap that reads a valid row; each input read once, the
    output written once."""
    import torch

    b, v, cin = feats.shape
    q, k, cout = nbr.shape[1], nbr.shape[2], w.shape[2]
    idx = nbr.long().clamp(max=v - 1)
    rows_ok = torch.gather(valid, 1, idx.view(b, -1)).view(b, q, k)
    live = int(((nbr < v) & rows_ok).sum())
    item = feats.element_size()
    nbytes = (feats.numel() * item + valid.numel() + nbr.numel() * 4
              + w.numel() * item + b * q * cout * item)
    return 2 * cin * cout * live, nbytes, live


def gemm_library(feats, valid, nbr, w):
    """JAX's fused form as two PyTorch calls on a prebuilt padded table: one
    index_select of B·Q·K rows, one matmul contracting K·Cin."""
    import torch

    b, v, cin = feats.shape
    q, k = nbr.shape[1], nbr.shape[2]
    table = torch.cat([torch.where(valid[..., None], feats, 0), feats.new_zeros(b, 1, cin)],
                      dim=1).reshape(b * (v + 1), cin)
    idx = (nbr.long() + torch.arange(b, device=nbr.device)[:, None, None] * (v + 1)).reshape(-1)
    w2 = w.reshape(k * cin, -1)
    return lambda: torch.matmul(table.index_select(0, idx).view(b * q, k * cin), w2)


def time_gemm(entry, feats, valid, nbr, w, reps=25):
    from dfu3d_tpu_torch.core.voxel import gather_gemm_kernel as gk

    ops, nbytes, live = gemm_costs(feats, valid, nbr, w)
    peak = BF16_PEAK if feats.dtype.itemsize == 2 else FP32_PEAK
    ops_ms, bytes_ms = ops / peak * 1e3, nbytes / HBM_RATE * 1e3
    library = gemm_library(feats, valid, nbr, w)
    entry.update(
        ms=time_ms(lambda: gk.gather_gemm(feats, valid, nbr, w), reps=reps),
        plain_ms=time_ms(lambda: gk.gather_gemm_plain(feats, valid, nbr, w),
                         reps=max(reps // 5, 3)),
        library_ms=time_ms(library, reps=max(reps // 5, 3)),
        bound_ms=max(ops_ms, bytes_ms), bound_by="operations" if ops_ms >= bytes_ms else "bytes",
        ops=ops, bytes=nbytes, live_taps=live,
        mean_live_taps=live / max(1, nbr.shape[0] * nbr.shape[1]))
    entry["share_of_bound"] = entry["bound_ms"] / entry["ms"]
    return entry


def check_gather_gemm_kernel(device):
    """Phase 3: the gather-GEMM kernel against its plain twin at the path's
    nine shapes in bf16 (random tables: uniform in [0, V], about 20 % invalid
    rows; the tensor-core variant), in fp32 at two of them (the CUDA-core
    variant), and at edge cases; tolerances in `gemm_agreement`."""
    import torch

    from dfu3d_tpu_torch.core.voxel import gather_gemm_kernel as gk

    gen = torch.Generator().manual_seed(1)

    def case(v, q, k, cin, cout, dtype, b=4, sentinel_rows=False):
        feats = torch.randn(b, v, cin, generator=gen)
        valid = torch.rand(b, v, generator=gen) > 0.2
        nbr = torch.randint(0, v + 1, (b, q, k), generator=gen, dtype=torch.int32)
        if sentinel_rows:
            nbr[:, ::5] = v
        w = torch.randn(k, cin, cout, generator=gen) / math.sqrt(k * cin)
        return tuple(t.to(device) for t in (feats.to(dtype), valid, nbr, w.to(dtype)))

    def compare(name, args, timed, variant=None):
        feats, valid, nbr, w = args
        k = w.shape[0]
        got, ran = launch_variant(lambda: gk.gather_gemm(*args))
        torch.cuda.synchronize()
        want = gk.gather_gemm_plain(*args)
        entry = {"case": name, "dtype": str(feats.dtype).replace("torch.", ""),
                 "shape": [list(feats.shape), list(nbr.shape), list(w.shape)], "variant": ran,
                 **gemm_agreement(args, got, want)}
        if not entry.pop("ok"):
            fail(f"gather-GEMM kernel vs plain on {name} {entry['dtype']}: {entry}")
        if variant and ran != variant:
            fail(f"gather-GEMM on {name} {entry['dtype']} ran the {ran} variant, not {variant}")
        if not torch.isfinite(got).all():
            fail(f"gather-GEMM on {name} {entry['dtype']}: output not finite")
        if timed:
            time_gemm(entry, *args)
        log(f"[kernels] gather_gemm {name} {entry['dtype']} ({ran}) V,Q,K,Cin,Cout="
            f"{feats.shape[1]},{nbr.shape[1]},{k},{w.shape[1]},{w.shape[2]}: max |kernel - plain| "
            f"{entry['max_abs_err']:.3g}"
            + (f" ({entry['max_err_in_ulps']:.2f} ulp; {entry['share_beyond_1ulp']:.2e} of the "
               "outputs beyond 1 ulp)" if "max_err_in_ulps" in entry else "")
            + (f", kernel {entry['ms']:.4f} ms, plain {entry['plain_ms']:.3f} ms, library "
               f"{entry['library_ms']:.3f} ms, bound {entry['bound_ms']:.4f} ms "
               f"({entry['bound_by']}, {entry['share_of_bound']:.1%})" if timed else ""))
        return entry, got

    per_shape = []
    for name, v, q, k, cin, cout, count in GEMM_PATH_SHAPES:
        entry, _ = compare(name, case(v, q, k, cin, cout, torch.bfloat16), True, "tensor_core")
        entry["launches_per_step"] = count
        per_shape.append(entry)
    for name in ("res1", "res4"):
        _, v, q, k, cin, cout, _ = next(s for s in GEMM_PATH_SHAPES if s[0] == name)
        per_shape.append(compare(name, case(v, q, k, cin, cout, torch.float32), False,
                                 "cuda_core")[0])
    for dtype in (torch.float32, torch.bfloat16):
        args = case(300, 333, 27, 4, 16, dtype, b=2, sentinel_rows=True)
        entry, got = compare("edge_ragged_cin4_sentinel_rows", args, False)
        if got[:, ::5].abs().max().item() != 0.0:
            fail("gather-GEMM: queries that read only the sentinel are not zero")
        per_shape.append(entry)
        per_shape.append(compare("edge_k3", case(200, 77, 3, 128, 128, dtype, b=1), False)[0])
        args = case(64, 70, 27, 8, 8, dtype, b=1)
        args = (args[0], args[1], torch.full_like(args[2], 64), args[3])
        entry, got = compare("edge_all_sentinel", args, False)
        if got.abs().max().item() != 0.0:
            fail("gather-GEMM: an all-sentinel table does not give zero")
        per_shape.append(entry)
    # the served tables' traits, on the tensor-core variant at down3's widths
    b, v, q, k = 2, 3000, 1500, 27
    feats, valid, nbr, w = case(v, q, k, 32, 64, torch.bfloat16, b=b)
    taps = torch.randint(0, k, (b, q, 1), generator=gen).to(device)
    one_tap = torch.full_like(nbr, v).scatter_(
        2, taps, torch.randint(0, v, (b, q, 1), generator=gen, dtype=torch.int32).to(device))
    per_shape.append(compare("edge_one_live_tap_per_row",
                             (feats, torch.ones_like(valid), one_tap, w), False, "tensor_core")[0])
    tiles = nbr.clone()
    tiles[:, 64:320] = v   # whole 64-row tiles 1-4 read only the sentinel
    entry, got = compare("edge_sentinel_tiles", (feats, valid, tiles, w), False, "tensor_core")
    if got[:, 64:320].abs().max().item() != 0.0:
        fail("gather-GEMM: tiles that read only the sentinel are not zero")
    per_shape.append(entry)
    bad = torch.tensor([float("nan"), float("inf"), -float("inf"), 1e30, -1e30], device=device)
    garbage = feats.clone()
    garbage[~valid] = bad[torch.arange(int((~valid).sum()), device=device) % 5][:, None].to(
        feats.dtype)
    per_shape.append(compare("edge_nan_in_masked_rows", (garbage, valid, nbr, w), False,
                             "tensor_core")[0])
    return per_shape


def pillar_counts(batch, grid, max_pillars):
    """Distinct in-range pillars per sample, and how many the global cap of
    B * max_pillars keeps (batch-major order)."""
    import numpy as np

    pts, valid = batch.points.cpu().numpy(), batch.points_valid.cpu().numpy()
    nx, ny, _ = grid.grid_size
    pcr = np.float32(grid.point_cloud_range[:2])
    ij = np.floor((pts[..., :2] - pcr) / np.float32(grid.voxel_size[:2])).astype(np.int64)
    inside = valid & (ij >= 0).all(-1) & (ij < [nx, ny]).all(-1)
    distinct = [len(np.unique(ij[i][inside[i]] @ [1, nx])) for i in range(len(pts))]
    left, kept = len(pts) * max_pillars, []
    for n in distinct:
        kept.append(min(n, left))
        left -= kept[-1]
    return distinct, kept


def serve(name, model, batches, device):
    """Phase 4 for one path: a warm-up request, then every kernel count set to
    0, the requests served, the counts read."""
    import torch

    from dfu3d_tpu_torch.train.eval_utils import eval_batches

    eval_batches(model, batches[:1], RECALL_THRESH, device=device, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    reset_launches()
    res = eval_batches(model, batches, RECALL_THRESH, device=device, dtype=torch.bfloat16)
    launches = read_launches()
    log(f"[serve] {name}: per-batch ms: median {statistics.median(res.batch_seconds) * 1e3:.2f} "
        f"(all: {', '.join(f'{s * 1e3:.2f}' for s in res.batch_seconds)})")
    for k, (boxes, scores, labels, valid) in enumerate(res.preds):
        if boxes.shape[:2] != (4, 498) or not torch.isfinite(boxes).all() \
                or not torch.isfinite(scores).all():
            fail(f"{name} batch {k}: boxes {tuple(boxes.shape)} not (4, 498, .) or not finite")
        kept = scores[valid]
        log(f"[serve] {name} batch {k}: valid boxes per sample {valid.sum(1).tolist()}, "
            f"scores of valid boxes min {kept.min().item() if len(kept) else 0:.4f} "
            f"median {kept.median().item() if len(kept) else 0:.4f}")
    log(f"[serve] {name}: recall counters {json.dumps(res.metric)}")
    log(f"[serve] {name}: kernel launches {json.dumps(launches)} "
        f"({', '.join(f'{v / len(batches):g}' for v in launches.values())} per batch)")
    if res.metric["gt_num"] != 16 * 4 * len(batches):
        fail(f"{name}: gt_num {res.metric['gt_num']} != {16 * 4 * len(batches)}")
    return res, launches


class plain_twins:
    """Within the block each (module, kernel name, plain name) of `swaps`
    calls the plain twin in place of the kernel."""

    def __init__(self, swaps):
        self.swaps = swaps

    def __enter__(self):
        self.saved = [(mod, k, getattr(mod, k)) for mod, k, _ in self.swaps]
        for mod, k, p in self.swaps:
            setattr(mod, k, getattr(mod, p))

    def __exit__(self, *exc):
        for mod, k, fn in self.saved:
            setattr(mod, k, fn)


def check_paths(name, model, cfg, batch, served, swaps, device):
    """Phase 5 for one path (and phase 10's fp32 request): one request in
    fp32 through the kernels and through their plain twins (`swaps`:
    (module, kernel name, plain name)),
    its gt made from boxes the serving run kept, shifted along x by
    0 .. 0.75 of their length so that the recall counters see IoUs on both
    sides of every threshold (predict does not read the gt)."""
    import torch

    from dfu3d_tpu_torch.core.geometry import nms as nms_mod
    from dfu3d_tpu_torch.train.train_state import make_eval_step

    pred_boxes, _, _, pred_valid = served
    gt = batch.gt_boxes.clone()
    for i in range(gt.shape[0]):
        kept = pred_boxes[i][pred_valid[i]]
        for j in range(16):
            gt[i, j, :7] = kept[(7 * j) % len(kept), :7]
            gt[i, j, 0] += 0.05 * j * gt[i, j, 3]
    check_batch = batch._replace(gt_boxes=gt)
    step = make_eval_step(model, RECALL_THRESH, device=device)
    nms_inputs = []
    orig_iou_bev = nms_mod.pairwise_iou_bev

    def recording_iou_bev(a, b):
        nms_inputs.append(a)
        return orig_iou_bev(a, b)

    nms_mod.pairwise_iou_bev = recording_iou_bev
    try:
        with_kernel = step(check_batch)
    finally:
        nms_mod.pairwise_iou_bev = orig_iou_bev
    with plain_twins(swaps):
        with_plain = step(check_batch)
    (kb, ks, kl, kv, krec), (pb, ps, pl, pv, prec) = with_kernel, with_plain
    # NMS decisions at the threshold that the two versions make differently
    cand = nms_inputs[0]
    iou_k = orig_iou_bev(cand, cand)
    with plain_twins(swaps):
        iou_p = orig_iou_bev(cand, cand)
    thresh = float(cfg.MODEL.DENSE_HEAD.POST_PROCESSING.NMS_CONFIG.NMS_THRESH
                   if "DENSE_HEAD" in cfg.MODEL else cfg.MODEL.ROI_HEAD.NMS_THRESH)
    flips = int(((iou_k > thresh) != (iou_p > thresh)).sum())
    near = int(((iou_k - thresh).abs() < 1e-5).sum())
    log(f"[check] {name} fp32 NMS IoU over {tuple(iou_k.shape)}: max |kernel - plain| "
        f"{(iou_k - iou_p).abs().max().item():.3g}, decisions flipped at {thresh}: {flips}, "
        f"pairs within 1e-5 of it: {near}")
    if not torch.equal(kv, pv):
        fail(f"{name} fp32 path: valid masks differ between kernel and plain "
             f"({int((kv != pv).sum())} slots; NMS flips {flips})")
    # Kept boxes are compared per sample as sets (box, score, label rows,
    # matched one to one), as the CPU parity tests compare the port with
    # JAX: two boxes whose scores differ by less than the kernels' rounding
    # may come out of top-K in either order. Slot by slot is reported too.
    slot_diff = ((kb - pb).abs().amax(-1) > PATH_TOL) | ((ks - ps).abs() > PATH_TOL) | (kl != pl)
    slot_diff &= kv
    match_err = 0.0
    for i in range(kb.shape[0]):
        rows_k = torch.cat([kb[i], ks[i, :, None], kl[i, :, None].float()], -1)[kv[i]]
        rows_p = torch.cat([pb[i], ps[i, :, None], pl[i, :, None].float()], -1)[pv[i]]
        dist = (rows_k[:, None, :] - rows_p[None, :, :]).abs().amax(-1)
        match = dist.argmin(0)
        if len(set(match.tolist())) != len(match):
            fail(f"{name} fp32 path: the kept boxes of sample {i} do not match one to one")
        match_err = max(match_err, dist[match, torch.arange(len(match))].max().item())
    # for each slot that differs: its score's distance to the nearest other
    # kept score of its sample (the smallest is 0, the slot itself)
    gaps = [(ks[i][kv[i]] - ks[i, j]).abs().topk(2, largest=False).values[1].item()
            for i, j in slot_diff.nonzero().tolist()]
    log(f"[check] {name} fp32 slot by slot: {int(slot_diff.sum())} of {int(kv.sum())} kept "
        f"slots differ (box, score or label)"
        + (f"; the nearest other kept score within the same sample is "
           f"{max(gaps):.3g} away at most for those slots" if gaps else ""))
    if not match_err <= PATH_TOL:
        fail(f"{name} fp32 path: kept boxes, scores and labels differ by {match_err} "
             f"(tol {PATH_TOL}) when matched as sets")
    box_err = (kb - pb).abs()[kv].max().item() if kv.any() else 0.0
    score_err = (ks - ps).abs()[kv].max().item() if kv.any() else 0.0
    krec = {k: int(v) for k, v in krec.items()}
    if krec != {k: int(v) for k, v in prec.items()}:
        fail(f"{name} fp32 path: recall counters differ {krec} vs {prec}")
    if not krec[f"recall_rcnn_{RECALL_THRESH[0]}"] > 0:
        fail(f"{name} fp32 path: no gt recalled although the gt are predicted boxes: {krec}")
    log(f"[check] {name} fp32 whole path, kernels vs plain: valid masks equal "
        f"({int(kv.sum())} boxes), kept boxes, scores and labels equal as sets within "
        f"{match_err:.3g}; slot by slot max |box diff| {box_err:.3g}, max |score diff| "
        f"{score_err:.3g}; recall {krec}")
    return {"kept_boxes": int(kv.sum()), "max_set_diff": match_err, "max_box_diff": box_err,
            "max_score_diff": score_err, "nms_decisions_flipped": flips,
            "nms_pairs_within_1e-5": near, "recall": krec}


def voxel_stages(model, batch, device):
    """Per stage of the voxel backbone on one request: active voxels, those
    the cap dropped, and the mean non-sentinel taps per active voxel of the
    table that makes the stage (down) and of its submanifold table (subm)."""
    import torch

    with torch.no_grad():
        b = batch.to(device)
        _, vox = model.vfe(b.points, b.points_valid)
        levels = model.backbone_3d.plan(vox.voxel_coords, vox.voxel_valid, vox.num_unique)
    out = []
    for i, (name, lv) in enumerate(zip(["input", "stride 2", "stride 4", "stride 8", "conv_out"],
                                       levels)):
        v = lv.coords.shape[1]
        entry = {"stage": name, "grid": list(lv.grid), "cap": v,
                 "active": lv.valid.sum(1).tolist(),
                 "dropped": torch.clamp(lv.num_unique - v, min=0).tolist()}
        for key, nbr, sentinel in (("down", lv.down_nbr, levels[i - 1].coords.shape[1]),
                                   ("subm", lv.subm_nbr, v)):
            if nbr is not None:
                entry[f"{key}_mean_taps"] = (nbr < sentinel).sum(-1).float()[lv.valid].mean().item()
        out.append(entry)
        log(f"[serve] voxel stage {name} {tuple(lv.grid)} cap {v}: active {entry['active']}, "
            f"dropped by the cap {entry['dropped']}, mean non-sentinel taps "
            + ", ".join(f"{k[:4]} {entry[k]:.3f}" for k in ("down_mean_taps", "subm_mean_taps")
                        if k in entry))
    return out


def record_gemm_calls(fn):
    """fn()'s gather-GEMM calls, in order: [(feats, valid, nbr, kernel)]."""
    import torch

    from dfu3d_tpu_torch.core.voxel import gather_gemm_kernel as gk

    calls = []
    kernel_fn = gk.gather_gemm

    def recording(*args):
        calls.append(args)
        return kernel_fn(*args)

    gk.gather_gemm = recording
    try:
        fn()
    finally:
        gk.gather_gemm = kernel_fn
    torch.cuda.synchronize()
    return calls


GEMM_CONVS = (["conv_input"] + [f"res1_{i}" for i in range(4)]
              + [n for s in (2, 3, 4) for n in [f"down{s}"] + [f"res{s}_{i}" for i in range(4)]]
              + ["conv_out"])   # the 21 sparse convs in forward order


def hold_gemm_calls(label, named_calls):
    """Each recorded gather-GEMM call (name, args) launched again, held
    against the plain twin on its own inputs (`gemm_agreement`; fatal on a
    miss or on another variant than the tensor-core one) and timed: kernel,
    plain, library, bound. Returns (totals, entries)."""
    import torch

    from dfu3d_tpu_torch.core.voxel import gather_gemm_kernel as gk

    entries = []
    for name, args in named_calls:
        got, ran = launch_variant(lambda: gk.gather_gemm(*args))
        torch.cuda.synchronize()
        e = {"conv": name, "shape": [list(args[0].shape), list(args[2].shape),
                                     list(args[3].shape)], "variant": ran,
             **gemm_agreement(args, got, gk.gather_gemm_plain(*args))}
        if not e.pop("ok") or ran != "tensor_core":
            fail(f"gather-GEMM {label}, {name}: {e}")
        entries.append(time_gemm(e, *args, reps=10))
    total = {k: sum(e[k] for e in entries) for k in ("ms", "plain_ms", "library_ms")}
    by = {"bytes": 0.0, "operations": 0.0}
    for e in entries:
        by[e["bound_by"]] += e["bound_ms"]
    total.update(bound_ms=sum(by.values()), bound_by=max(by, key=by.get), launches=len(entries),
                 max_err_in_ulps=max(e["max_err_in_ulps"] for e in entries))
    log(f"[kernels] gather_gemm {label} ({len(entries)} launches, all tensor-core, each within "
        f"tolerance of the plain twin, worst {total['max_err_in_ulps']:.2f} ulp): kernel "
        f"{total['ms']:.3f} ms, plain {total['plain_ms']:.3f} ms, library "
        f"{total['library_ms']:.3f} ms, bound {total['bound_ms']:.4f} ms ({total['bound_by']}); "
        "per conv (kernel / library / bound): "
        + ", ".join(f"{e['conv']} {e['ms']:.4f}/{e['library_ms']:.4f}/{e['bound_ms']:.4f}"
                    for e in entries))
    slower = [e["conv"] for e in entries if e["ms"] > e["library_ms"]]
    if slower:
        log(f"[kernels] gather_gemm slower than the library form on: {', '.join(slower)}")
    return total, entries


def time_served_gemms(model, batch, device):
    """The 21 gather-GEMM launches of one served bf16 request, each held
    against the plain twin and timed (`hold_gemm_calls`)."""
    import torch

    from dfu3d_tpu_torch.train.train_state import make_eval_step

    calls = record_gemm_calls(
        lambda: make_eval_step(model, device=device, dtype=torch.bfloat16)(batch))
    return hold_gemm_calls("on one served request", zip(GEMM_CONVS, calls))


def reset_launches():
    from dfu3d_tpu_torch.core.geometry import iou_kernel
    from dfu3d_tpu_torch.core.voxel import gather_gemm_kernel

    iou_kernel.launches = gather_gemm_kernel.launches = 0
    gather_gemm_kernel.launches_by_variant.update(tensor_core=0, cuda_core=0)


def read_launches():
    from dfu3d_tpu_torch.core.geometry import iou_kernel
    from dfu3d_tpu_torch.core.voxel import gather_gemm_kernel

    return {"iou_bev_overlap": iou_kernel.launches, "gather_gemm": gather_gemm_kernel.launches,
            **{f"gather_gemm_{k}": n for k, n in gather_gemm_kernel.launches_by_variant.items()}}


def train(name, build, batches, device):
    """Phase 6 for one model (and phase 11's steps): a bf16 step through
    train_model per batch with every kernel count set to 0 just before and
    read just after, the checkpoint round trip, and the checks on each step.
    `batches` may be made as they are read (phase 11 makes part of each
    batch's gt then): a step's host clock starts once its batch is in hand.
    Returns (model, launches, steps, state)."""
    import torch

    from dfu3d_tpu_torch.flagship import seeded_weights_
    from dfu3d_tpu_torch.train import checkpoint
    from dfu3d_tpu_torch.train.train_state import create_train_state
    from dfu3d_tpu_torch.train.trainer import train_model

    cfg, _, model = build(device=device, train=True)
    seeded_weights_(model, seed=0)
    state = create_train_state(model, cfg.OPTIMIZATION, TRAIN_TOTAL_STEPS)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    steps, last = [], {}

    def on_step(it, metrics):
        vals = {k: float(v) for k, v in metrics.items()}   # waits for the card
        now = time.perf_counter()
        launched = read_launches()
        step = {"it": it, **vals, "host_ms": (now - last["t"]) * 1e3,
                **{k: launched[k] - last["launches"][k] for k in launched}}
        last.update(launches=launched)
        steps.append(step)
        terms = ", ".join(f"{k} {v:.4f}" for k, v in vals.items() if k not in ("loss", "grad_norm"))
        log(f"[train] {name} step {it}: loss {vals['loss']:.4f} ({terms}), grad_norm "
            f"{vals['grad_norm']:.4f}, {step['host_ms']:.2f} ms host clock; B1 "
            f"{step['iou_bev_overlap']}, gather-GEMM {step['gather_gemm_tensor_core']} "
            f"tensor-core / {step['gather_gemm_cuda_core']} CUDA-core launches")
        if not all(math.isfinite(v) for v in vals.values()):
            fail(f"{name} train step {it}: loss or gradient not finite {vals}")

    def fed():
        for batch in batches:
            last.update(t=time.perf_counter())
            yield batch

    with tempfile.TemporaryDirectory() as ckpt_dir:
        torch.cuda.synchronize()
        reset_launches()
        last.update(launches=read_launches())
        train_model(state, fed(), epochs=1, ckpt_dir=ckpt_dir, device=device,
                    dtype=torch.bfloat16, on_step=on_step)
        launches = read_launches()
        _, _, fresh_model = build(device=device, train=True)
        fresh = create_train_state(fresh_model, cfg.OPTIMIZATION, TRAIN_TOTAL_STEPS)
        loaded, epoch = checkpoint.load_latest(ckpt_dir, fresh)
    if loaded is None or epoch != 1 or fresh.step != len(steps):
        fail(f"{name}: the checkpoint did not reload (epoch {epoch}, step {fresh.step})")
    for k, v in model.state_dict().items():
        if not torch.equal(v, fresh_model.state_dict()[k]):
            fail(f"{name}: reloaded model differs from the trained one at {k}")
    want, got = state.optimizer.opt.state_dict(), fresh.optimizer.opt.state_dict()
    if want["param_groups"] != got["param_groups"] or any(
            not torch.equal(torch.as_tensor(v).cpu(), torch.as_tensor(got["state"][i][k]).cpu())
            for i, st in want["state"].items() for k, v in st.items()):
        fail(f"{name}: reloaded optimizer state differs from the trained one")
    unchanged = [k for k, v in model.state_dict().items() if torch.equal(v, before[k])]
    if unchanged:
        fail(f"{name}: {len(unchanged)} parameters or BN buffers unchanged by training, "
             f"e.g. {unchanged[:5]}")
    if not all(torch.isfinite(v).all() for v in model.state_dict().values()):
        fail(f"{name}: a parameter or buffer is not finite after training")
    ms = [s["host_ms"] for s in steps]
    median = statistics.median(ms)
    log(f"[train] {name}: {len(steps)} steps, median {median:.2f} ms host clock "
        f"({4 / (median / 1e3):.2f} samples/s; without the first step "
        f"{statistics.median(ms[1:]):.2f} ms); checkpoint reloaded equal "
        f"(model {len(before)} tensors, optimizer step {fresh.step}); "
        f"{len(before) - len(unchanged)} of {len(before)} parameters and BN buffers changed; "
        f"kernel launches {json.dumps(launches)}")
    return model, launches, steps, state


def time_train_dx(model, batch, device):
    """The 20 dX launches of one bf16 voxel train step (forward and backward,
    no update), each held against the plain twin on its own inputs and timed
    (`hold_gemm_calls`)."""
    import torch

    def step():
        model.train()
        model.zero_grad(set_to_none=True)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            loss, _ = model(batch.to(device))
        loss.backward()
        model.zero_grad(set_to_none=True)

    calls = record_gemm_calls(step)
    if len(calls) != VOXEL_TRAIN_B2:
        fail(f"one voxel train step made {len(calls)} gather-GEMM calls, not {VOXEL_TRAIN_B2}")
    fwd, dx = calls[:len(GEMM_CONVS)], calls[len(GEMM_CONVS):]
    # the backward runs the convs in reverse; conv_input's input needs no dX
    for name, f, args in zip(GEMM_CONVS[::-1], fwd[::-1], dx):
        k, cin, cout = f[3].shape
        if tuple(args[3].shape) != (k, cout, cin) or args[0].shape != (f[0].shape[0],
                                                                       f[2].shape[1], cout):
            fail(f"dX launch for {name}: shapes {[tuple(a.shape) for a in args]} do not mirror "
                 f"its forward's {[tuple(a.shape) for a in f]}")
    return hold_gemm_calls("dX of one voxel train step", zip(GEMM_CONVS[::-1], dx))


def gather_gemm_plain_reversed(feats, valid, nbr, kernel):
    """The plain twin summing the taps in reverse order: the same function
    with another fp32 rounding (the yardstick of check_train_paths)."""
    from dfu3d_tpu_torch.core.voxel import gather_gemm_kernel as gk

    return gk.gather_gemm_plain(feats, valid, nbr.flip(-1).contiguous(),
                                kernel.flip(0).contiguous())


def check_train_paths(name, model, batch, swaps, device):
    """One fp32 train step (loss and gradients, no update) through the kernels
    against the same step through their plain twins (`swaps`: (module,
    kernel, plain)) from the same weights. The loss of the step all through
    the twins must be within TRAIN_LOSS_TOL relative. The gradients are
    compared with the forward through the kernels in both runs and only the
    backward's launches (B2's dX) swapped: at full width some of the step's
    millions of ReLU inputs lie within fp32 rounding of 0, and a forward
    rounded otherwise takes a few of them on the other side of the kink,
    which moves every upstream gradient by up to ~1e-3 of its largest entry
    (tests/test_torch_port_train_slice.py documents the effect). Each leaf
    must be within TRAIN_GRAD_TOL of its largest entry or, where fp32
    rounding alone moves it more, within 4x the difference between the
    plain backward and the plain backward with the taps summed in reverse
    order (the same function rounded otherwise)."""
    import torch

    from dfu3d_tpu_torch.core.voxel import gather_gemm_kernel as gk

    weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    batch = batch.to(device)

    def step(forward=(), backward=None):
        replace = list(forward) + ([(gk, "gather_gemm", backward)] if backward else [])
        saved = [(mod, k, getattr(mod, k)) for mod, k, _ in replace]
        try:
            for mod, k, fn in forward:
                setattr(mod, k, fn)
            model.load_state_dict(weights)
            model.train()
            model.zero_grad(set_to_none=True)
            loss, _ = model(batch)
            if backward:
                gk.gather_gemm = backward
            loss.backward()
            torch.cuda.synchronize()
        finally:
            for mod, k, fn in saved:
                setattr(mod, k, fn)
        return loss.item(), {k: p.grad.detach().clone() for k, p in model.named_parameters()}

    k_loss, k_grads = step()
    p_loss, _ = step(forward=[(mod, k, getattr(mod, p)) for mod, k, p in swaps])
    _, p_grads = step(backward=gk.gather_gemm_plain)
    _, r_grads = step(backward=gather_gemm_plain_reversed)
    model.load_state_dict(weights)
    rel = abs(k_loss - p_loss) / abs(p_loss)
    leaves = []
    for key, pg in p_grads.items():
        scale = pg.abs().max().item()
        module, leaf = key.rsplit(".", 1)
        if leaf == "bias" and f"{module}.weight" in p_grads:
            # a conv bias in front of a BN: its gradient is 0 up to rounding
            scale = max(scale, p_grads[f"{module}.weight"].abs().max().item())
        if not torch.isfinite(k_grads[key]).all() or not scale > 0:
            fail(f"{name} fp32 train step: gradient {key} not finite or all zero")
        err = (k_grads[key] - pg).abs().max().item() / scale
        spread = (r_grads[key] - pg).abs().max().item() / scale
        leaves.append((err / max(TRAIN_GRAD_TOL, 4 * spread), key, err, spread))
    leaves.sort(reverse=True)
    within = sum(err <= TRAIN_GRAD_TOL for _, _, err, _ in leaves)
    log(f"[check] {name} fp32 train step: loss through the kernels {k_loss:.6f}, through the "
        f"plain twins {p_loss:.6f} ({rel:.2e} relative); gradients with the dX launches "
        f"through the kernel vs the plain twin: {within} of {len(leaves)} leaves within "
        f"{TRAIN_GRAD_TOL:g} of their largest entry; worst leaves (kernel - plain, plain - "
        "plain reversed, of the leaf's largest entry): "
        + ", ".join(f"{key} {err:.2e} / {spread:.2e}" for _, key, err, spread in leaves[:5]))
    if not rel <= TRAIN_LOSS_TOL or leaves[0][0] > 1.0:
        fail(f"{name} fp32 train step: kernels vs plain twins differ (loss {rel:.3g} relative, "
             f"gradient {leaves[0][1]} {leaves[0][2]:.3g} of its largest entry where the "
             f"plain path's own rounding moves it {leaves[0][3]:.3g})")
    return {"loss_rel_err": rel, "leaves_within_tol": within, "leaves": len(leaves),
            "worst": [{"leaf": key, "kernel_vs_plain": err, "plain_vs_reversed": spread}
                      for _, key, err, spread in leaves[:5]]}


def synthetic_kitti_root(base, class_names):
    """Phase 7's data: CLI_TRAIN_FRAMES + CLI_VAL_FRAMES frames of 40,000-60,000
    points in the camera frustum and 20-40 boxes of the flagship's ten
    classes (kitti_synthetic), laid out as the flagship's dataset config
    expects with DATA_PATH = base/train_28130: the frames in DATA_PATH, the
    val infos in base/val_6019/ (INFO_PATH.test is ../val_6019/...). Infos
    and gt database come from tools.create_infos and are renamed to the
    config's file names. Returns (DATA_PATH, seconds to write the frames,
    seconds of create_infos)."""
    from dfu3d_tpu_torch.data import kitti_synthetic
    from dfu3d_tpu_torch.tools import create_infos

    root = base / "train_28130"
    t0 = time.perf_counter()
    kitti_synthetic.write_root(root, CLI_TRAIN_FRAMES, CLI_VAL_FRAMES, class_names, seed=0)
    t1 = time.perf_counter()
    out = create_infos.main(["--cfg_file", CLI_CFG, "--data_path", str(root)])
    t2 = time.perf_counter()
    infos = dict(zip(("train", "val"), out["infos"]))
    (base / "val_6019").mkdir()
    infos["train"].rename(root / "nuscenes2kitti_infos_train_28130_initial_pseudo_box.pkl")
    infos["val"].rename(base / "val_6019" / "nuscenes2kitti_infos_val_6019.pkl")
    out["dbinfos"].rename(root / "nuscenes2kitti_dbinfos_train_28130.pkl")
    return root, t1 - t0, t2 - t1


def flagship_on(root):
    from dfu3d_tpu_torch.tools.common import load_config

    class Args:
        cfg_file, set_cfgs = CLI_CFG, ["DATA_CONFIG.DATA_PATH", str(root)]

    return load_config(Args)


def ap_round_trip(cfg):
    """The val gt fed back as predictions (scores uniform in [0.5, 1]) through
    the prediction writer and the KITTI AP; Car 3D and BEV easy R40 must
    exceed AP_ROUND_TRIP_MIN."""
    import numpy as np

    from dfu3d_tpu_torch.data.dataset import BatchMeta
    from dfu3d_tpu_torch.data.kitti_dataset import KittiDataset

    ds = KittiDataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, training=False)
    rng = np.random.RandomState(0)
    ids = [info["point_cloud"]["lidar_idx"] for info in ds.kitti_infos]
    preds = [{"pred_boxes": info["annos"]["gt_boxes_lidar"],
              "pred_scores": rng.uniform(0.5, 1.0, len(info["annos"]["name"])),
              "pred_labels": np.array([cfg.CLASS_NAMES.index(n) + 1
                                       for n in info["annos"]["name"]])}
             for info in ds.kitti_infos]
    meta = BatchMeta(ids, [ds.get_calib(i) for i in ids],
                     [info["image"]["image_shape"] for info in ds.kitti_infos])
    t0 = time.perf_counter()
    _, ap = ds.evaluation(ds.generate_prediction_dicts(meta, preds, cfg.CLASS_NAMES),
                          cfg.CLASS_NAMES)
    seconds = time.perf_counter() - t0
    keys = ("Car_3d/easy_R40", "Car_bev/easy_R40", "Car_3d/moderate_R40")
    got = {k: float(ap[k]) for k in keys}
    log(f"[cli] AP round trip (val gt as predictions, {len(ids)} frames, "
        f"{sum(len(p['pred_labels']) for p in preds)} boxes): "
        + ", ".join(f"{k} {v:.4f}" for k, v in got.items()) + f"; {seconds:.2f} s")
    if not (got["Car_3d/easy_R40"] > AP_ROUND_TRIP_MIN and got["Car_bev/easy_R40"] > AP_ROUND_TRIP_MIN):
        fail(f"AP round trip: {got} not above {AP_ROUND_TRIP_MIN}")
    return {**got, "seconds": seconds}


def loader_rate(cfg, workers):
    """Frames/s of KittiDataset.__getitem__ + collate with the flagship's
    augmentations (gt sampling and four world augmentations) over the train
    split, through the loader with `workers` threads (two epochs, B=4), and
    one thread's ms per frame."""
    from dfu3d_tpu_torch.data.loader import build_dataloader

    dataset, loader = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size=4,
                                       workers=workers, training=True)
    t0 = time.perf_counter()
    for i in range(len(dataset)):
        dataset[i]
    one_thread_ms = (time.perf_counter() - t0) / len(dataset) * 1e3
    frames, points = 0, []
    t0 = time.perf_counter()
    for epoch in range(2):
        loader.set_epoch(epoch)
        for batch, _ in loader:
            frames += batch.points.shape[0]
            points += batch.points_valid.sum(1).tolist()
    seconds = time.perf_counter() - t0
    return {"workers": workers, "frames": frames, "seconds": seconds,
            "frames_per_s": frames / seconds, "one_thread_ms_per_frame": one_thread_ms,
            "points_per_frame": [min(points), max(points)]}


def eval_kernels_vs_plain(cfg, ckpt, swaps, device):
    """The eval epoch in fp32 on the trained weights, once through the
    kernels and once through their plain twins (one loader thread and
    np.random seeded before each, so that both see the same points in the
    same order): recall counters equal, each frame's kept boxes, scores and
    classes equal as sets within PATH_TOL, and every AP within EVAL_AP_TOL."""
    import numpy as np
    import torch

    from dfu3d_tpu_torch.data.loader import build_dataloader
    from dfu3d_tpu_torch.train.checkpoint import load_checkpoint
    from dfu3d_tpu_torch.train.eval_utils import eval_one_epoch
    from dfu3d_tpu_torch.tools.common import build_model

    model = build_model(cfg, "test", device)
    model.load_state_dict(load_checkpoint(ckpt)[0]["model_state"])
    dataset, loader = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size=4,
                                       workers=1, training=False)
    runs = []
    for twins in (False, True):
        np.random.seed(0)
        with plain_twins(swaps if twins else []):
            runs.append(eval_one_epoch(model, dataset, loader, cfg, device=device,
                                       dtype=torch.float32))
    (_, k_res, k_annos), (_, p_res, p_annos) = runs
    counters = [k for k in k_res if k == "gt_num" or k.startswith("recall_rcnn_")]
    if any(k_res[k] != p_res[k] for k in counters):
        fail(f"eval epoch fp32: recall counters differ, kernels "
             f"{ {k: k_res[k] for k in counters} } vs plain { {k: p_res[k] for k in counters} }")
    match_err, exact, kept = 0.0, True, 0
    for k, p in zip(k_annos, p_annos):
        rows_k = np.concatenate([k["boxes_lidar"], k["score"][:, None]], 1)
        rows_p = np.concatenate([p["boxes_lidar"], p["score"][:, None]], 1)
        if k["frame_id"] != p["frame_id"] or len(rows_k) != len(rows_p):
            fail(f"eval epoch fp32: frame {k['frame_id']} keeps {len(rows_k)} boxes through "
                 f"the kernels, {len(rows_p)} through the plain twins")
        kept += len(rows_k)
        if not len(rows_k):
            continue
        dist = np.abs(rows_k[:, None] - rows_p[None]).max(-1)
        match = dist.argmin(0)
        if len(set(match.tolist())) != len(match) or (k["name"][match] != p["name"]).any():
            fail(f"eval epoch fp32: frame {k['frame_id']}'s kept boxes do not match one to one")
        match_err = max(match_err, float(dist[match, np.arange(len(match))].max()))
        exact &= bool(np.array_equal(rows_k, rows_p))
    if not match_err <= PATH_TOL:
        fail(f"eval epoch fp32: kept boxes and scores differ by {match_err} (tol {PATH_TOL})")
    ap_keys = [key for key in k_res if "_R40" in key]
    ap_err = max(abs(float(k_res[key]) - float(p_res[key])) for key in ap_keys)
    log(f"[cli] eval epoch fp32, kernels vs plain twins: recall counters equal "
        f"{ {k: k_res[k] for k in counters} }; {kept} kept boxes equal as sets within "
        f"{match_err:.3g} (bit for bit: {exact}); {len(ap_keys)} APs within {ap_err:.3g}")
    if not ap_err <= EVAL_AP_TOL:
        fail(f"eval epoch fp32: an AP differs by {ap_err} between kernels and plain twins "
             f"(tol {EVAL_AP_TOL})")
    return {"recall_counters": {k: k_res[k] for k in counters}, "kept_boxes": kept,
            "max_box_score_diff": match_err, "bit_for_bit": exact, "max_ap_diff": ap_err}


def cli(device, pillar_step_ms):
    """Phase 7: the flagship trained and evaluated from disk through the
    port's CLIs, on a synthetic KITTI root in a temporary working directory
    (its cfgs/ links to tools/cfgs/, so the flagship's YAML runs unedited
    with only DATA_CONFIG.DATA_PATH set). Returns (the summary, launches in
    training, launches in evaluation)."""
    import os

    from dfu3d_tpu_torch.core.geometry import iou_kernel
    from dfu3d_tpu_torch.tools import test as test_cli, train as train_cli

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as work:
        work = Path(work)
        (work / "cfgs").symlink_to(REPO / "tools" / "cfgs")
        os.chdir(work)
        try:
            cfg = flagship_on(work / "train_28130")
            root, write_s, infos_s = synthetic_kitti_root(work, cfg.CLASS_NAMES)
            log(f"[cli] synthetic root: {CLI_TRAIN_FRAMES} train + {CLI_VAL_FRAMES} val frames "
                f"written in {write_s:.2f} s; tools.create_infos {infos_s:.2f} s")
            round_trip = ap_round_trip(cfg)
            rate = loader_rate(cfg, LOADER_WORKERS)
            needed = 4 / (pillar_step_ms / 1e3)
            log(f"[cli] loader, flagship augmentations, {rate['workers']} threads: "
                f"{rate['frames_per_s']:.2f} frames/s ({rate['frames']} frames in "
                f"{rate['seconds']:.2f} s, {rate['points_per_frame']} points per frame); one "
                f"thread {rate['one_thread_ms_per_frame']:.1f} ms per frame; the phase-6 pillar "
                f"train step ({pillar_step_ms:.2f} ms, B=4) consumes {needed:.1f} frames/s")

            common = ["--cfg_file", CLI_CFG, "--workers", str(LOADER_WORKERS), "--extra_tag",
                      "chip_smoke"]
            data_path = ["--set", "DATA_CONFIG.DATA_PATH", str(root)]
            reset_launches()
            t0 = time.perf_counter()
            trained = train_cli.main([*common, "--epochs", "1", "--fix_random_seed", *data_path])
            train_s = time.perf_counter() - t0
            train_launches = read_launches()
            (epoch,) = trained["epochs"]
            ckpt = trained["ckpt_dir"] / "checkpoint_epoch_1.pth"
            log(f"[cli] tools.train: {epoch['steps']} steps, losses "
                f"{[round(v, 4) for v in epoch['losses']]}, data_time {epoch['data_time']:.3f} s, "
                f"batch_time {epoch['batch_time']:.3f} s "
                f"({epoch['batch_time'] / max(epoch['steps'], 1) * 1e3:.1f} ms per step host "
                f"clock), {train_s:.2f} s in all; kernel launches {json.dumps(train_launches)}")
            if not epoch["steps"] or not all(math.isfinite(v) for v in epoch["losses"]):
                fail(f"tools.train: a loss is not finite or no step ran: {epoch}")
            if not ckpt.exists():
                fail(f"tools.train wrote no {ckpt}")
            if train_launches["iou_bev_overlap"] or train_launches["gather_gemm"]:
                fail(f"tools.train launched a kernel that is not on the train path: "
                     f"{train_launches}")

            reset_launches()
            t0 = time.perf_counter()
            ((_, result_dir, res),) = test_cli.main([*common, "--ckpt", str(ckpt),
                                                     "--save_to_file", *data_path])
            test_s = time.perf_counter() - t0
            eval_launches = read_launches()
            txts = len(list((result_dir / "final_result" / "data").glob("*.txt")))
            log_file = next((trained["output_dir"] / "eval").glob("log_eval_*.txt"))
            ap_dict = json.loads(log_file.read_text().split("AP_DICT ", 1)[1].splitlines()[0])
            split = {k: res[k] for k in res if k.startswith("time/")}
            log(f"[cli] tools.test: {res['num_frames']} frames in {res['eval_batches']} batches, "
                f"{res['sec_per_example']:.4f} s/frame, split (s) {json.dumps(split)}, "
                f"recall {json.dumps({k: res[k] for k in res if k.startswith('recall/')})}, "
                f"{txts} KITTI txts, {test_s:.2f} s in all; kernel launches "
                f"{json.dumps(eval_launches)}")
            missing = [c for c in cfg.CLASS_NAMES if f"{c}_3d/moderate_R40" not in ap_dict]
            if txts != CLI_VAL_FRAMES or missing:
                fail(f"tools.test: {txts} txts for {CLI_VAL_FRAMES} val frames; AP_DICT lacks "
                     f"{missing}")
            if eval_launches["iou_bev_overlap"] != 2 * res["eval_batches"] or \
                    eval_launches["gather_gemm"]:
                fail(f"tools.test: kernel launches {eval_launches}, not 2 overlap launches per "
                     f"eval batch ({res['eval_batches']}) and no gather-GEMM")
            versus = eval_kernels_vs_plain(cfg, ckpt, [(iou_kernel, "overlap_bev",
                                                        "overlap_bev_plain")], device)
        finally:
            os.chdir(cwd)
    summary = {"frames": {"train": CLI_TRAIN_FRAMES, "val": CLI_VAL_FRAMES},
               "write_s": write_s, "create_infos_s": infos_s, "ap_round_trip": round_trip,
               "loader": {**rate, "pillar_step_ms": pillar_step_ms,
                          "frames_per_s_a_step_consumes": needed},
               "train": {**epoch, "ms_per_step": epoch["batch_time"] / epoch["steps"] * 1e3,
                         "seconds": train_s, "launches": train_launches},
               "eval": {"sec_per_example": res["sec_per_example"], "split_s": split,
                        "eval_batches": res["eval_batches"], "num_frames": res["num_frames"],
                        "recall": {k: res[k] for k in res if k.startswith("recall")},
                        "gt_num": res["gt_num"], "txts": txts, "seconds": test_s,
                        "launches": eval_launches,
                        "ap_3d_moderate_R40": {c: ap_dict[f"{c}_3d/moderate_R40"]
                                               for c in cfg.CLASS_NAMES}},
               "fp32_kernels_vs_plain": versus}
    return summary, train_launches, eval_launches


def pair_straddle(a, pts, valid, r):
    """For each point a_i (F, 3) against its candidates pts (F, M, 3) where
    valid (F, M): the smallest | |a_i - pts_ij| - r_i | over j, in float64."""
    import numpy as np

    d = np.sqrt(((a[:, None].astype(np.float64) - pts.astype(np.float64)) ** 2).sum(-1))
    return np.where(valid, np.abs(d - np.asarray(r, np.float64)[:, None]), np.inf).min(-1)


def frame_program_flips(packed, ball_gate_c, device):
    """The frame program's radius tests on the card and on the CPU from the
    same inputs, the CPU's masks feeding the next test on both: the LiDAR and
    pseudo radius-outlier masks, the ball gate, and the BEV reach of the
    compacted points. Each entry that differs gets the distance from its
    test's radius of the pairs that decide it (the smallest over them).
    Also whether the card's bf16 adjacency equals the fp32 product of its
    own reach, which is exact for 0/1 operands. Returns (flips, exact):
    flips maps each test to the straddles (m) of its differing entries."""
    import numpy as np
    import torch

    from dfu3d_tpu_torch.pseudo import ops

    cpu = torch.device("cpu")

    def on(dev, a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    lid, lid_v, pse, pse_v = packed.lidar, packed.lidar_valid, packed.pseudo, packed.pseudo_valid
    masks = {dev: {} for dev in (device, cpu)}
    for dev in (device, cpu):
        for name, pts, valid in (("lidar_radius", lid, lid_v), ("pseudo_radius", pse, pse_v)):
            masks[dev][name] = ops.radius_outlier_mask(on(dev, pts), on(dev, valid),
                                                       on(dev, packed.radii)).cpu().numpy()
    ref = masks[cpu]
    for dev in (device, cpu):
        masks[dev]["ball_gate"] = ops.ball_gate_mask(
            on(dev, pse), on(dev, ref["pseudo_radius"]), on(dev, lid), on(dev, ref["lidar_radius"]),
            ball_gate_c).cpu().numpy()
    # frame_program's compaction: kept points first, in order
    keep = np.concatenate([ref["lidar_radius"], ref["ball_gate"]], 1)
    order = np.argsort(~keep, axis=1, kind="stable")[:, :lid.shape[1]]
    pts_c = np.take_along_axis(np.concatenate([lid, pse], 1), order[..., None], 1)
    keep_c = np.take_along_axis(keep, order, 1)
    for dev in (device, cpu):
        masks[dev]["reach"] = ops.reach(on(dev, pts_c), on(dev, keep_c)).cpu().numpy()
    reach_card = on(device, masks[device]["reach"]).float()
    exact = torch.equal(ops.adjacency(on(device, pts_c), on(device, keep_c)),
                        (reach_card @ reach_card.transpose(-1, -2)) > 0)

    flips = {}
    for name, pts, valid, rad in (("lidar_radius", lid, lid_v, packed.radii),
                                  ("pseudo_radius", pse, pse_v, packed.radii),
                                  ("ball_gate", pse, ref["lidar_radius"], None)):
        k, i = np.nonzero(masks[device][name] != ref[name])
        others = lid if name == "ball_gate" else pts
        r = np.full(len(k), ball_gate_c) if rad is None else rad[k]
        flips[name] = pair_straddle(pts[k, i], others[k], valid[k], r).tolist()
    k, i, j = np.nonzero(masks[device]["reach"] != ref["reach"])
    p = pts_c.astype(np.float64)
    r = 3.0 + 0.001 * np.linalg.norm(p[k, i], axis=-1)     # ops.reach's r0 + rd·‖p_i‖
    flips["reach"] = np.abs(np.linalg.norm(p[k, i, :2] - p[k, j, :2], axis=-1) - r).tolist()
    return flips, exact


def factory_cuda_vs_cpu(root, ids, device):
    """The same frames through the factory on the card and on the CPU with
    the same RANSAC triples: names and box counts equal, boxes within
    PSEUDO_BOX_TOL matched one to one, fused clouds equal. The frame
    program's radius tests and adjacency are also held stage by stage
    (frame_program_flips): every differing mask or reach entry must lie
    within PSEUDO_STRADDLE of its radius, and the bf16 adjacency must be
    exact. Differing boxes pass only where the above-plane masks agree and
    such an entry, printed, explains them."""
    import numpy as np
    import torch

    from dfu3d_tpu_torch.pseudo import factory as pf
    from dfu3d_tpu_torch.pseudo import ops
    from dfu3d_tpu_torch.tools.generate_pseudo_boxes import fov_only

    out = []
    for idx in ids:
        frame = fov_only(pf.load_frame_inputs(root, idx))
        valid = torch.zeros(pf.LIDAR_CAP, dtype=torch.bool)
        valid[:min(len(frame.lidar), pf.LIDAR_CAP)] = True
        triples = ops.sample_ground_triples(valid, pf.RANSAC_ITERS,
                                            torch.Generator().manual_seed(int(idx)))
        card, cpu = pf.PseudoBoxFactory(device=device), pf.PseudoBoxFactory(device="cpu")
        got = card.process_frame(frame, triples=triples)
        t0 = time.perf_counter()
        want = cpu.process_frame(frame, triples=triples)
        cpu_s = time.perf_counter() - t0
        same = sorted(got.names) == sorted(want.names) and len(got.names) == len(want.names)
        err = 0.0
        if same and len(got.names):
            dist = np.abs(got.boxes_lidar[:, None] - want.boxes_lidar[None]).max(-1)
            match = dist.argmin(0)
            same = (len(set(match.tolist())) == len(match)
                    and [got.names[i] for i in match] == want.names)
            err = float(dist[match, np.arange(len(match))].max())
        _, above = card.plane_and_above(frame.lidar, triples)
        above_flips = int((above != cpu.plane_and_above(frame.lidar, triples)[1]).sum())
        pseudo, pix = card.densify(frame)
        packed = card.pack_instances(frame, frame.lidar[above], pseudo, pix)
        flips, adjacency_exact = frame_program_flips(packed, card.ball_gate_c, device)
        straddles = [s for v in flips.values() for s in v]
        entry = {"frame": idx, "boxes": len(got.names), "max_box_diff": err, "cpu_s": cpu_s,
                 "fused_equal": bool(np.array_equal(got.fused_points, want.fused_points)),
                 "above_flips": above_flips, "flips": {k: len(v) for k, v in flips.items()},
                 "max_straddle_m": max(straddles, default=None),
                 "adjacency_exact": adjacency_exact,
                 "sweeps": [card.last_stats["sweeps"], cpu.last_stats["sweeps"]]}
        log(f"[pseudo] frame {idx} on the card and on the CPU ({cpu_s:.2f} s): {entry['boxes']} "
            f"boxes, names equal {same}, max box diff {err:.3g}, fused clouds equal "
            f"{entry['fused_equal']}; above-plane flips {above_flips}, radius-test flips "
            f"{entry['flips']} (largest straddle {entry['max_straddle_m']} m), bf16 adjacency "
            f"exact {adjacency_exact}; label sweeps {entry['sweeps']}")
        if not (entry["fused_equal"] and adjacency_exact
                and all(s <= PSEUDO_STRADDLE for s in straddles)):
            fail(f"pseudo factory on the card vs the CPU, frame {idx}: {entry}")
        if not (same and err <= PSEUDO_BOX_TOL) and not (above_flips == 0 and straddles):
            fail(f"pseudo factory on the card vs the CPU, frame {idx}: the boxes differ and no "
                 f"radius-test flip explains it: {entry}")
        out.append(entry)
    return out


def depth_cuda_vs_cpu(root, idx, device):
    """One enet_ref depth map (seeded weights, 352 x 1216) in fp32 on the card
    and on the CPU: max |diff| within DEPTH_TOL of the map's largest |depth|."""
    import numpy as np
    import torch

    from dfu3d_tpu_torch.core.geometry.calibration import Calibration
    from dfu3d_tpu_torch.data import kitti_io
    from dfu3d_tpu_torch.pseudo.synthetic import IMG_H, IMG_W
    from dfu3d_tpu_torch.tools.complete_depth import DepthCompleter, build_depth_model

    torch.manual_seed(0)
    card = build_depth_model("enet_ref", device)
    cpu = build_depth_model("enet_ref", "cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    calib = Calibration(root / "calib" / f"{idx}.txt")
    lidar = kitti_io.read_velodyne_bin(root / "velodyne" / f"{idx}.bin")
    image = kitti_io.read_png(root / "image_2" / f"{idx}.png")
    got = DepthCompleter(card, "enet_ref", IMG_H, IMG_W, device, torch.float32)(image, lidar, calib)
    tf32 = DepthCompleter(card, "enet_ref", IMG_H, IMG_W, device, torch.float32,
                          tf32=True)(image, lidar, calib)
    t0 = time.perf_counter()
    want = DepthCompleter(cpu, "enet_ref", IMG_H, IMG_W, torch.device("cpu"),
                          torch.float32)(image, lidar, calib)
    cpu_s = time.perf_counter() - t0
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    tf32_err = float(np.abs(tf32 - want).max())
    log(f"[pseudo] enet_ref fp32 {IMG_H}x{IMG_W}, card vs CPU ({cpu_s:.2f} s): max |diff| "
        f"{err:.3g} m of max |depth| {scale:.3g} m ({err / max(scale, 1e-30):.3g}; tol "
        f"{DEPTH_TOL}); the card's TF32 convolutions would read {tf32_err:.3g} m "
        f"({tf32_err / max(scale, 1e-30):.3g})")
    if not (scale > 0 and np.isfinite(got).all() and err <= DEPTH_TOL * scale):
        fail(f"enet_ref fp32 on the card vs the CPU: max |diff| {err} of {scale}")
    return {"hw": [IMG_H, IMG_W], "max_abs_diff": err, "max_abs_depth": scale,
            "rel": err / scale, "tol": DEPTH_TOL, "tf32_rel": tf32_err / scale, "cpu_s": cpu_s}


def pseudo(device):
    """Phase 8: pipeline 2 from raw frames to the detector's infos. Every kernel
    count is set to 0 just before complete_depth and read just after
    generate_pseudo_boxes. Returns (the summary, launches)."""
    import numpy as np

    from dfu3d_tpu_torch.pseudo import synthetic
    from dfu3d_tpu_torch.tools import complete_depth, create_infos, generate_pseudo_boxes

    with tempfile.TemporaryDirectory() as work:
        work = Path(work)
        root = work / "pseudo_root"
        t0 = time.perf_counter()
        ids, _ = synthetic.make_dataset(root, n_train=PSEUDO_FRAMES, n_val=0)
        write_s = time.perf_counter() - t0
        reset_launches()
        t0 = time.perf_counter()
        depth = complete_depth.main(["--detpath", str(root), "--model", "enet_ref",
                                     "--out_dir", str(work / "depth_enet_ref"), "--seed", "0"])
        depth_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        gen = generate_pseudo_boxes.main(["--detpath", str(root), "--seed", "0"])
        gen_s = time.perf_counter() - t0
        launches = read_launches()
        maps = [np.load(p) for p in depth["written"]]
        if len(maps) != PSEUDO_FRAMES or not all(
                m.shape == (352, 1216) and np.isfinite(m).all() and (m != 0).any() for m in maps):
            fail(f"tools.complete_depth wrote {len(maps)} maps, not {PSEUDO_FRAMES} finite "
                 "(352, 1216) maps")
        labels = sorted(p.stem for p in (root / "label_train").glob("*.txt"))
        clouds = sorted(p.stem for p in (root / "velodyne_depth").glob("*.npy"))
        if labels != ids or clouds != ids or gen["frames"] != ids:
            fail(f"tools.generate_pseudo_boxes wrote labels {labels} and clouds {clouds} for "
                 f"frames {ids}")
        if any(launches.values()):
            fail(f"the pseudo path launched a kernel that is not on it: {launches}")
        log(f"[pseudo] {PSEUDO_FRAMES} frames written in {write_s:.2f} s; tools.complete_depth "
            f"enet_ref bf16: {depth_s:.2f} s ({PSEUDO_FRAMES / depth_s:.2f} frames/s with the "
            f"model's set-up); tools.generate_pseudo_boxes: {gen_s:.2f} s "
            f"({gen['frames_per_s']:.2f} frames/s), boxes per frame {gen['boxes']}")

        t0 = time.perf_counter()
        out = create_infos.main(["--cfg_file", str(REPO / "tools" / CLI_CFG), "--data_path",
                                 str(root), "--label_dir", "label_train", "--suffix",
                                 "_initial_pseudo_box", "--splits", "train"])
        infos_s = time.perf_counter() - t0
        infos = np.load(out["infos"][0], allow_pickle=True)
        counts = {info["point_cloud"]["lidar_idx"]: len(info["annos"]["name"]) for info in infos}
        if counts != gen["boxes"]:
            fail(f"create_infos counts {counts} boxes, the factory wrote {gen['boxes']}")
        recalled = total = 0
        for info in infos:
            annos = info["annos"]
            cars = annos["gt_boxes_lidar"][annos["name"] == "Car"]
            _, gt, _ = synthetic.make_scene(seed=int(info["point_cloud"]["lidar_idx"]))
            rec = synthetic.bev_recovery(cars, gt)
            recalled += rec["recalled"]
            total += rec["gt"]
        recall = recalled / total
        log(f"[pseudo] tools.create_infos ({infos_s:.2f} s): box counts equal the factory's; "
            f"gt Cars recovered at BEV IoU >= 0.5: {recalled} of {total} = {recall:.4f} "
            f"(floor {PSEUDO_RECALL_MIN})")
        if not recall >= PSEUDO_RECALL_MIN:
            fail(f"pseudo-box recovery {recall:.4f} below {PSEUDO_RECALL_MIN}")
        card_vs_cpu = factory_cuda_vs_cpu(root, ids[:2], device)
        depth_check = depth_cuda_vs_cpu(root, ids[0], device)
    summary = {"frames": PSEUDO_FRAMES, "write_s": write_s,
               "complete_depth": {"model": "enet_ref", "dtype": "bfloat16", "seconds": depth_s,
                                  "frames_per_s": PSEUDO_FRAMES / depth_s},
               "generate_pseudo_boxes": {"seconds": gen_s, "frames_per_s": gen["frames_per_s"],
                                         "boxes": gen["boxes"]},
               "create_infos_s": infos_s, "launches": launches,
               "recovery": {"recalled": recalled, "gt": total, "recall": recall,
                            "floor": PSEUDO_RECALL_MIN},
               "factory_card_vs_cpu": card_vs_cpu, "depth_card_vs_cpu": depth_check}
    return summary, launches


def nuscenes_tree(root, frames):
    """A raw-table nuScenes tree (the JSON tables, LIDAR_TOP clouds; no camera
    images) of `frames` key frames chained by `next`: the ego drives along +x
    (identity rotation, 2 m per frame), LIDAR_TOP sits at the ego origin turned
    -90 deg about z (x right, y forward), CAM_FRONT 1.5 m up looking along +x,
    and frame k has one car 10 + k m ahead and 0.5 k m to the left of the ego,
    with a cluster of 100 points on it. Returns the car's KITTI-lidar centre
    per frame (x forward, y left: the ego frame)."""
    import numpy as np

    from dfu3d_tpu_torch.data.nuscenes_tables import Quaternion

    tdir = root / "v1.0-mini"
    tdir.mkdir(parents=True)
    (root / "samples" / "LIDAR_TOP").mkdir(parents=True)
    rng = np.random.RandomState(0)
    lid_rot = Quaternion(axis=(0, 0, 1), angle=-np.pi / 2)
    cam_rot = Quaternion(matrix=np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], dtype=float))
    tables = {
        "sensor": [{"token": "sen_lid", "channel": "LIDAR_TOP", "modality": "lidar"},
                   {"token": "sen_cam", "channel": "CAM_FRONT", "modality": "camera"}],
        "calibrated_sensor": [
            {"token": "cs_lid", "sensor_token": "sen_lid", "translation": [0, 0, 0],
             "rotation": lid_rot.q.tolist(), "camera_intrinsic": []},
            {"token": "cs_cam", "sensor_token": "sen_cam", "translation": [0, 0, 1.5],
             "rotation": cam_rot.q.tolist(),
             "camera_intrinsic": [[1266.0, 0, 800.0], [0, 1266.0, 450.0], [0, 0, 1]]}],
        "log": [{"token": "log0", "logfile": "log0"}],
        "scene": [{"token": "scene0", "log_token": "log0", "name": "scene-0001"}],
        "category": [{"token": "cat_car", "name": "vehicle.car"}],
        "ego_pose": [], "sample": [], "sample_data": [], "sample_annotation": []}
    want = []
    for k in range(frames):
        ego_x = 2.0 * k
        car = np.array([10.0 + k, 0.5 * k, 1.0])
        want.append(car)
        # the cluster in the nuScenes LIDAR frame (x right, y forward)
        pts = rng.uniform(-0.5, 0.5, (100, 3)) + [-car[1], car[0], car[2]]
        np.concatenate([pts, rng.uniform(0, 1, (100, 1)), np.zeros((100, 1))],
                       1).astype(np.float32).tofile(root / "samples" / "LIDAR_TOP" / f"lid{k}.bin")
        last = k == frames - 1
        tables["ego_pose"].append({"token": f"pose{k}", "translation": [ego_x, 0, 0],
                                   "rotation": [1, 0, 0, 0]})
        tables["sample"].append({"token": f"samp{k}", "scene_token": "scene0",
                                 "timestamp": 500000 * k})
        tables["sample_data"] += [
            {"token": f"sd_lid{k}", "sample_token": f"samp{k}", "is_key_frame": True,
             "calibrated_sensor_token": "cs_lid", "ego_pose_token": f"pose{k}",
             "filename": f"samples/LIDAR_TOP/lid{k}.bin",
             "next": "" if last else f"sd_lid{k + 1}"},
            {"token": f"sd_cam{k}", "sample_token": f"samp{k}", "is_key_frame": True,
             "calibrated_sensor_token": "cs_cam", "ego_pose_token": f"pose{k}",
             "filename": f"samples/CAM_FRONT/cam{k}.jpg", "next": ""}]
        tables["sample_annotation"].append({
            "token": f"ann{k}", "sample_token": f"samp{k}", "category_token": "cat_car",
            "translation": [ego_x + car[0], car[1], car[2]], "size": [1.8, 4.0, 1.6],
            "rotation": [1, 0, 0, 0]})
    for name, rows in tables.items():
        (tdir / f"{name}.json").write_text(json.dumps(rows))
    return want


def nuscenes_to_kitti(work):
    """Pipeline 1 on the host: tools.nuscenes2kitti on NUSC_FRAMES raw-table
    frames; each frame's car read back through the port's calibration and
    label reader must sit at its KITTI-lidar centre within NUSC_TOL."""
    import numpy as np

    from dfu3d_tpu_torch.core.geometry.calibration import Calibration
    from dfu3d_tpu_torch.data import kitti_io
    from dfu3d_tpu_torch.tools import nuscenes2kitti

    want = nuscenes_tree(work / "nuscenes", NUSC_FRAMES)
    t0 = time.perf_counter()
    out = nuscenes2kitti.main(["--dataroot", str(work / "nuscenes"), "--nusc_kitti_dir",
                               str(work / "nusc_kitti"), "--split", "all", "--image_count",
                               str(NUSC_FRAMES), "--nusc_version", "v1.0-mini"])
    seconds = time.perf_counter() - t0
    err = cloud_err = 0.0
    for k, car in enumerate(want):
        calib = Calibration(out / "calib" / f"{k:06d}.txt")
        objs = kitti_io.get_objects_from_label(out / "label_2" / f"{k:06d}.txt")
        if len(objs) != 1 or objs[0].cls_type != "Car":
            fail(f"nuscenes2kitti frame {k}: labels {[o.cls_type for o in objs]}, not one Car")
        loc = calib.rect_to_lidar(objs[0].loc[None])[0]
        loc[2] += objs[0].h / 2
        err = max(err, float(np.abs(loc - car).max()))
        pts = np.fromfile(out / "velodyne" / f"{k:06d}.bin", np.float32).reshape(-1, 4)
        cloud_err = max(cloud_err, float(np.abs(pts[:, :3].mean(0) - car).max()))
    poses = len(list((out / "pose").glob("*.txt")))
    log(f"[evolve] tools.nuscenes2kitti: {NUSC_FRAMES} frames in {seconds:.3f} s, {poses} ego-pose "
        f"pairs; each car read back through the calibration within {err:.4f} m (tol {NUSC_TOL}), "
        f"its point cluster's mean in the KITTI-lidar cloud within {cloud_err:.3f} m")
    if not (err <= NUSC_TOL and cloud_err <= 0.2) or poses != NUSC_FRAMES - 1:
        fail(f"nuscenes2kitti: a car off by {err} m, a cloud by {cloud_err} m, or {poses} pose "
             "files")
    return {"frames": NUSC_FRAMES, "seconds": seconds, "max_err_m": err,
            "cloud_err_m": cloud_err, "pose_files": poses}


def evolve_flagship(work, device):
    """tools.evolve --rounds 1 on the flagship config from disk over phase 7's
    layout. Kernel counts are set to 0 just before and read just after: the
    pillar train launches neither kernel, the predict pass (every epoch's
    checkpoint, --eval_all) B1 twice per eval batch. label_refine0 must be
    the newest epoch's predictions byte for byte, and the rebuilt infos must
    count each frame's labels. --score_thresh 0: a model trained EVOLVE_EPOCHS
    short epochs from scratch scores nothing above the config's 0.1, and the
    phase checks the round's plumbing at the size of the detector's output,
    not the model."""
    import numpy as np

    from dfu3d_tpu_torch.tools import evolve

    cfg = flagship_on(work / "train_28130")
    root, _, _ = synthetic_kitti_root(work, cfg.CLASS_NAMES)
    reset_launches()
    t0 = time.perf_counter()
    (rec,) = evolve.main(["--cfg_file", CLI_CFG, "--rounds", "1", "--epochs", str(EVOLVE_EPOCHS),
                          "--score_thresh", "0.0", "--device", device.type, "--set",
                          "DATA_CONFIG.DATA_PATH", str(root)])
    seconds = time.perf_counter() - t0
    launches = read_launches()
    epochs = [e for e, _, _ in rec["predictions"]]
    batches = sum(res["eval_batches"] for _, _, res in rec["predictions"])
    newest = rec["prediction_dir"]
    if epochs != list(range(1, EVOLVE_EPOCHS + 1)) or newest.parts[-4] != f"epoch_{EVOLVE_EPOCHS}":
        fail(f"tools.evolve predicted epochs {epochs} and took {newest}")
    if launches["iou_bev_overlap"] != 2 * batches or launches["gather_gemm"]:
        fail(f"tools.evolve: kernel launches {launches}, not 2 overlap launches per eval batch "
             f"({batches}) and no gather-GEMM")
    labels = sorted(rec["label_dir"].glob("*.txt"))
    if [p.name for p in labels] != sorted(p.name for p in newest.glob("*.txt")) or any(
            p.read_bytes() != (newest / p.name).read_bytes() for p in labels):
        fail(f"{rec['label_dir']} is not a copy of the newest epoch's predictions {newest}")
    infos = np.load(rec["next_info"], allow_pickle=True)
    counts = {i["point_cloud"]["lidar_idx"]: len(i["annos"]["name"]) for i in infos}
    lines = {p.stem: len(p.read_text().splitlines()) for p in labels}
    if counts != lines or not sum(lines.values()):
        fail(f"the rebuilt infos count {counts} boxes where label_refine0 holds {lines}")
    log(f"[evolve] tools.evolve --rounds 1 --epochs {EVOLVE_EPOCHS} (flagship, {CLI_TRAIN_FRAMES} "
        f"frames): {seconds:.2f} s ({json.dumps({k: round(v, 3) for k, v in rec['seconds'].items()})}); "
        f"predict pass over epochs {epochs}: {batches} eval batches, kernel launches "
        f"{json.dumps(launches)}; label_refine0 = epoch {EVOLVE_EPOCHS}'s predictions, "
        f"{sum(lines.values())} boxes, the rebuilt infos count the same per frame")
    return {"seconds": seconds, "split_s": rec["seconds"], "epochs_predicted": epochs,
            "eval_batches": batches, "launches": launches, "boxes": sum(lines.values()),
            "train_steps": sum(e["steps"] for e in rec["train"]["epochs"])}


def e2e_pillar(work, device):
    """tools.e2e_synthetic, 3 classes, pillar, one refine round; fatal when a
    class is missing from an AP_DICT or the round keeps no box (the script
    raises). Kernel counts are set to 0 just before and read just after: B1
    twice per eval batch over the initial eval, the predict pass and the
    round's eval; no B2. Returns (summary, launches)."""
    from dfu3d_tpu_torch.tools import e2e_synthetic

    classes = ["Car", "Pedestrian", "Cyclist"]
    reset_launches()
    t0 = time.perf_counter()
    out = e2e_synthetic.main(["--workdir", str(work / "e2e_pillar"), "--device", device.type,
                              "--classes", ",".join(classes), "--evolve_rounds", "1",
                              "--n_train", str(E2E_FRAMES[0]), "--n_val", str(E2E_FRAMES[1]),
                              "--epochs", str(E2E_EPOCHS), "--batch_size", str(E2E_BATCH)])
    seconds = time.perf_counter() - t0
    launches = read_launches()
    (rnd,) = out["rounds"]
    for name, ap in (("initial", out["eval"]), ("refine0", rnd["eval"])):
        missing = [c for c in classes if f"{c}_3d/moderate_R40" not in ap]
        if missing:
            fail(f"e2e_synthetic {name}: AP_DICT lacks {missing}")
    batches = (out["eval"]["eval_batches"] + rnd["predict"]["eval_batches"]
               + rnd["eval"]["eval_batches"])
    if launches["iou_bev_overlap"] != 2 * batches or launches["gather_gemm"]:
        fail(f"e2e_synthetic pillar: kernel launches {launches}, not 2 overlap launches per "
             f"eval batch ({batches}) and no gather-GEMM")
    steps = [sum(e["steps"] for e in t["epochs"]) for t in (out["train"], rnd["train"])]
    log(f"[evolve] e2e_synthetic pillar {','.join(classes)}, {E2E_FRAMES[0]} + {E2E_FRAMES[1]} "
        f"frames, {E2E_EPOCHS} epochs of {steps[0]} steps in all, one refine round: "
        f"{seconds:.2f} s; FACTORY_QUALITY {json.dumps(out['factory_quality'])}; AP history "
        f"{out['ap_history']}; the round kept {rnd['kept']}/{rnd['total']} boxes >= "
        f"{rnd['thresh']:.3f}; split (s) initial {json.dumps({k: round(v, 3) for k, v in out['seconds'].items()})}, "
        f"round {json.dumps({k: round(v, 3) for k, v in rnd['seconds'].items()})}; kernel "
        f"launches {json.dumps(launches)}")
    summary = {"classes": classes, "frames": list(E2E_FRAMES), "epochs": E2E_EPOCHS,
               "batch_size": E2E_BATCH, "train_steps": steps, "seconds": seconds,
               "factory_quality": out["factory_quality"], "ap_history": out["ap_history"],
               "per_class_history": rnd["per_class_history"],
               "round": {k: rnd[k] for k in ("kept", "total", "thresh", "predicted_epoch")},
               "split_s": {"initial": out["seconds"], "refine0": rnd["seconds"]},
               "eval_batches": batches, "launches": launches}
    return summary, launches


def predict_kernel_vs_plain(work, device):
    """One refine round's predict pass in fp32 from the pillar run's initial
    checkpoint, through B1 and through its plain twin (one loader thread),
    each filtered as the round filters: the kept label sets must be equal
    (names equal, numbers within PATH_TOL as sets)."""
    import numpy as np

    from dfu3d_tpu_torch.core.geometry import iou_kernel
    from dfu3d_tpu_torch.tools import e2e_synthetic, test as test_cli

    workdir = work / "e2e_pillar"
    rel_cfg = next((workdir / "cfgs" / "synthetic").glob("*.yaml")).relative_to(workdir)
    ckpt = e2e_synthetic.newest_checkpoint(
        workdir / "output" / "synthetic" / rel_cfg.stem / "default" / "ckpt")
    frames = (workdir / "data" / "ImageSets" / "train.txt").read_text().split()
    kept = {}
    for twins in (False, True):
        tag = "plain" if twins else "kernel"
        np.random.seed(0)
        with e2e_synthetic.working_dir(workdir), plain_twins(
                [(iou_kernel, "overlap_bev", "overlap_bev_plain")] if twins else []):
            ((_, result_dir, _),) = test_cli.main([
                "--cfg_file", str(rel_cfg), "--ckpt", str(ckpt), "--save_to_file", "--eval_tag",
                f"fp32_{tag}", "--workers", "1", "--device", device.type, "--dtype", "float32",
                "--set", "DATA_CONFIG.DATA_SPLIT.test", "train",
                "DATA_CONFIG.INFO_PATH.test", "['kitti_infos_train.pkl']"])
        label_dir = workdir / f"label_fp32_{tag}"
        stats = e2e_synthetic.filter_round(workdir / result_dir / "final_result" / "data",
                                           frames, label_dir, 0.5, f"fp32 {tag}")
        kept[tag] = (label_dir, stats)
    err, exact = 0.0, True
    for f in frames:
        rows = []
        for tag in ("kernel", "plain"):
            lines = [line.split() for line in (kept[tag][0] / f"{f}.txt").read_text().splitlines()
                     if line]
            rows.append(([r[0] for r in lines],
                         np.array([[float(x) for x in r[1:]] for r in lines]).reshape(-1, 15)))
        (kn, kv), (pn, pv) = rows
        if len(kn) != len(pn):
            fail(f"fp32 predict pass, frame {f}: {len(kn)} kept boxes through B1, {len(pn)} "
                 "through the plain twin")
        if not len(kn):
            continue
        dist = np.abs(kv[:, None] - pv[None]).max(-1)
        match = dist.argmin(0)
        if len(set(match.tolist())) != len(match) or [kn[i] for i in match] != pn:
            fail(f"fp32 predict pass, frame {f}: the kept boxes do not match one to one")
        err = max(err, float(dist[match, np.arange(len(match))].max()))
        exact &= bool(np.array_equal(kv, pv)) and kn == pn
    if not err <= PATH_TOL:
        fail(f"fp32 predict pass: kept boxes differ by {err} between B1 and its plain twin")
    stats = {tag: kept[tag][1] for tag in kept}
    log(f"[evolve] one round's predict pass in fp32 from {ckpt.name}: refined labels through B1 "
        f"and through its plain twin equal ({stats['kernel']['kept']} kept of "
        f"{stats['kernel']['total']} at {stats['kernel']['thresh']:.3f}; numbers within "
        f"{err:.3g}, line for line: {exact})")
    return {"kept": stats, "max_diff": err, "line_for_line": exact}


def e2e_voxel(work, device):
    """tools.e2e_synthetic --model voxel --evolve_rounds 0 --epochs 1: fatal
    unless every bf16 train step launches the tensor-core B2 VOXEL8X_TRAIN_B2
    times (12 forward, 11 dX) and no CUDA-core variant; the eval launches B2 12
    times per batch. Then each of one served request's 12 B2 calls and one
    train step's 11 dX calls is held against the plain twin and timed.
    Returns (summary, launches, served totals and entries, dX totals and
    entries)."""
    import torch

    from dfu3d_tpu_torch.data.loader import build_dataloader
    from dfu3d_tpu_torch.tools import e2e_synthetic
    from dfu3d_tpu_torch.tools import train as train_cli
    from dfu3d_tpu_torch.tools.common import build_model
    from dfu3d_tpu_torch.train.checkpoint import load_model_state
    from dfu3d_tpu_torch.train.train_state import make_eval_step
    from dfu3d_tpu_torch.utils.config import CfgDict, cfg_from_yaml_file

    steps, last = [], {}
    train_model = train_cli.train_model

    def counted(*args, **kw):
        def on_step(it, metrics):
            float(metrics["loss"])          # waits for the card
            launched = read_launches()
            steps.append({k: launched[k] - last[k] for k in launched})
            last.update(launched)
        last.update(read_launches())
        return train_model(*args, **kw, on_step=on_step)

    reset_launches()
    train_cli.train_model = counted
    t0 = time.perf_counter()
    try:
        out = e2e_synthetic.main([
            "--workdir", str(work / "e2e_voxel"), "--device", device.type, "--model", "voxel",
            "--evolve_rounds", "0", "--epochs", "1", "--n_train", str(VOXEL_E2E_FRAMES[0]),
            "--n_val", str(VOXEL_E2E_FRAMES[1]), "--batch_size", str(VOXEL_E2E_BATCH)])
    finally:
        train_cli.train_model = train_model
    seconds = time.perf_counter() - t0
    launches = read_launches()
    bad = [s for s in steps if s["gather_gemm_tensor_core"] != VOXEL8X_TRAIN_B2
           or s["gather_gemm_cuda_core"]]
    if not steps or bad:
        fail(f"e2e_synthetic voxel: a train step did not launch the tensor-core gather-GEMM "
             f"exactly {VOXEL8X_TRAIN_B2} times: {bad or 'no step ran'}")
    eval_batches = out["eval"]["eval_batches"]
    if launches["gather_gemm_tensor_core"] != VOXEL8X_TRAIN_B2 * len(steps) + 12 * eval_batches \
            or launches["gather_gemm_cuda_core"] or \
            launches["iou_bev_overlap"] != 2 * eval_batches:
        fail(f"e2e_synthetic voxel: kernel launches {launches} for {len(steps)} train steps and "
             f"{eval_batches} eval batches")
    log(f"[evolve] e2e_synthetic voxel (VoxelBackBone8x), {VOXEL_E2E_FRAMES[0]} + "
        f"{VOXEL_E2E_FRAMES[1]} frames, 1 epoch: {seconds:.2f} s; {len(steps)} train steps, each "
        f"{VOXEL8X_TRAIN_B2} tensor-core gather-GEMM launches (12 forward, 11 dX); eval "
        f"{eval_batches} batches; kernel launches {json.dumps(launches)}; AP "
        f"{out['ap_history']}")

    # the new B2 shapes: one served request and one train step's dX
    workdir = work / "e2e_voxel"
    cfg_file = next((workdir / "cfgs" / "synthetic").glob("*.yaml"))
    cfg = cfg_from_yaml_file(cfg_file, CfgDict())
    ckpt = e2e_synthetic.newest_checkpoint(
        workdir / "output" / "synthetic" / cfg_file.stem / "default" / "ckpt")
    _, loader = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size=VOXEL_E2E_BATCH,
                                 workers=1, training=True)
    batch = next(iter(loader))[0].to(device)
    model = build_model(cfg, "test", device)
    load_model_state(ckpt, model)
    calls = record_gemm_calls(
        lambda: make_eval_step(model, device=device, dtype=torch.bfloat16)(batch))
    if len(calls) != len(VOXEL8X_CONVS):
        fail(f"one VoxelBackBone8x eval step made {len(calls)} gather-GEMM calls, not 12")
    served = hold_gemm_calls("VoxelBackBone8x, one served request", zip(VOXEL8X_CONVS, calls))
    model = build_model(cfg, "train", device, train=True)
    load_model_state(ckpt, model)

    def step():
        model.zero_grad(set_to_none=True)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            loss, _ = model(batch)
        loss.backward()
        model.zero_grad(set_to_none=True)

    calls = record_gemm_calls(step)
    if len(calls) != VOXEL8X_TRAIN_B2:
        fail(f"one VoxelBackBone8x train step made {len(calls)} gather-GEMM calls, not "
             f"{VOXEL8X_TRAIN_B2}")
    dx = hold_gemm_calls("dX of one VoxelBackBone8x train step",
                         zip(VOXEL8X_CONVS[::-1], calls[len(VOXEL8X_CONVS):]))
    summary = {"frames": list(VOXEL_E2E_FRAMES), "batch_size": VOXEL_E2E_BATCH,
               "seconds": seconds, "train_steps": steps, "eval_batches": eval_batches,
               "launches": launches, "ap_history": out["ap_history"],
               "split_s": out["seconds"]}
    return summary, launches, served, dx


def evolve_phase(device):
    """Phase 9: pipelines 1 and 4 in a temporary working directory whose cfgs/
    links to tools/cfgs/."""
    import os

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as work:
        work = Path(work)
        (work / "cfgs").symlink_to(REPO / "tools" / "cfgs")
        os.chdir(work)
        try:
            nusc = nuscenes_to_kitti(work)
            flagship_round = evolve_flagship(work, device)
            pillar, pillar_launches = e2e_pillar(work, device)
            versus = predict_kernel_vs_plain(work, device)
            voxel, voxel_launches, served, dx = e2e_voxel(work, device)
        finally:
            os.chdir(cwd)
    summary = {"nuscenes2kitti": nusc, "evolve_flagship": flagship_round,
               "e2e_pillar": pillar, "predict_fp32_kernel_vs_plain": versus,
               "e2e_voxel": voxel}
    launches = {"evolve_predict": flagship_round["launches"], "e2e_pillar": pillar_launches,
                "e2e_voxel": voxel_launches}
    return summary, launches, served, dx


POINTRCNN_CLI_CFG = "cfgs/kitti_models/pointrcnn_nuscenes2kitti.yaml"  # from phase 10's work dir
POINTRCNN_REQUESTS = 4
POINTRCNN_B1_PER_BATCH = 3   # proposal NMS, final NMS, recall
POINTRCNN_OVERLAPS = ("proposal_nms", "final_nms", "recall")


def pointrcnn_serve(model, batches, device):
    """Phase 10's serving run: a warm-up request, every kernel count set to 0,
    the requests through eval_batches (bf16), the counts read. Fatal unless
    B1 launched POINTRCNN_B1_PER_BATCH times per batch and B2 never, or on a
    non-finite or misshapen output."""
    import torch

    from dfu3d_tpu_torch.train.eval_utils import eval_batches

    eval_batches(model, batches[:1], RECALL_THRESH, device=device, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    reset_launches()
    res = eval_batches(model, batches, RECALL_THRESH, device=device, dtype=torch.bfloat16)
    launches = read_launches()
    ms = [v * 1e3 for v in res.batch_seconds]
    log(f"[pointrcnn] {len(batches)} requests of B=4: ms per request median "
        f"{statistics.median(ms):.2f} (all: {', '.join(f'{v:.2f}' for v in ms)}); kernel "
        f"launches {json.dumps(launches)}; recall counters {json.dumps(res.metric)}")
    if launches["iou_bev_overlap"] != POINTRCNN_B1_PER_BATCH * len(batches) or \
            launches["gather_gemm"]:
        fail(f"the PointRCNN serving run launched {launches}, not B1 "
             f"{POINTRCNN_B1_PER_BATCH} times per batch and B2 never")
    kept = []
    for k, (boxes, scores, labels, valid) in enumerate(res.preds):
        if boxes.shape[:2] != (4, 128) or not torch.isfinite(boxes).all() \
                or not torch.isfinite(scores).all():
            fail(f"PointRCNN batch {k}: boxes {tuple(boxes.shape)} not (4, 128, 7) or not "
                 f"finite")
        if valid.any() and (labels[valid].min() < 1 or labels[valid].max() > 8):
            fail(f"PointRCNN batch {k}: labels outside 1..8")
        kept.append(valid.sum(1).tolist())
    log(f"[pointrcnn] kept boxes per frame {kept}")
    return res, launches, ms, kept


DEFERRED_PROFILES = []


def defer_device_profile(tag, run):
    """Queue torch.profiler over one step, run(), for the end of the script
    (`run_deferred_profiles`), and return the dict it then fills: the card's
    busy and idle share and its top kernels. A step run after torch.profiler
    in the same process is slower on the host (`profile_train`'s
    step_ms_after_profiler), so it runs after every host-clock reading."""
    device = {}

    def profile():
        from dfu3d_tpu_torch import profile_serve

        prof = profile_serve.device_profile(run, 1)[1]
        device.update({k: v for k, v in prof.items() if k != "top_kernels"})
        log(f"[{tag}] device over one step {json.dumps(device)}")
        device["top_kernels"] = prof.get("top_kernels", [])[:8]

    DEFERRED_PROFILES.append(profile)
    return device


def run_deferred_profiles():
    while DEFERRED_PROFILES:
        DEFERRED_PROFILES.pop(0)()


def pointrcnn_profile(model, batches, device):
    """Where one request's time goes (profile_serve.pointrcnn_profile over
    the requests: the spans' medians, the FPS share, the keep-scan's
    iterations per NMS call) and the card's busy and idle share over the
    first request (torch.profiler, deferred to the end of the script; its
    trace holds ~50,000 launches a request, and reading it back costs more
    host time than the request)."""
    import torch

    from dfu3d_tpu_torch import profile_serve
    from dfu3d_tpu_torch.train.train_state import make_eval_step

    step = make_eval_step(model, RECALL_THRESH, device=device, dtype=torch.bfloat16)
    out = profile_serve.pointrcnn_profile(model, lambda b: profile_serve._run(step, b), batches)

    def run():
        *_, recall = step(batches[0])
        int(recall["gt_num"])

    out["device_time"] = defer_device_profile("pointrcnn", run)
    log(f"[pointrcnn] instrumented request {out['phase_ms']['step']:.2f} ms, FPS "
        f"{out['fps_ms']:.2f} ms ({out['fps_share']:.1%}); keep-scan iterations "
        f"{[(tuple(c['shape']), c['iterations']) for c in out['keep_scan'][:2]]}")
    return out


def pointrcnn_cli(work, root, model, device):
    """tools.test with the PointRCNN config on phase 7's root (its val split),
    from a checkpoint of the seeded weights: fatal unless every class's 3D
    moderate R40 is in AP_DICT, one KITTI txt per val frame, and B1 launched
    POINTRCNN_B1_PER_BATCH times per eval batch, B2 never."""
    import torch

    from dfu3d_tpu_torch.tools import test as test_cli

    ckpt = work / "pointrcnn_seeded.pth"
    torch.save({"model_state": model.state_dict(), "epoch": 0}, ckpt)
    reset_launches()
    t0 = time.perf_counter()
    ((_, result_dir, res),) = test_cli.main([
        "--cfg_file", POINTRCNN_CLI_CFG, "--ckpt", str(ckpt), "--workers", str(LOADER_WORKERS),
        "--extra_tag", "chip_smoke", "--save_to_file", "--set", "DATA_CONFIG.DATA_PATH",
        str(root)])
    seconds = time.perf_counter() - t0
    launches = read_launches()
    txts = len(list((result_dir / "final_result" / "data").glob("*.txt")))
    log_file = next(result_dir.parents[2].glob("log_eval_*.txt"))
    ap_dict = json.loads(log_file.read_text().split("AP_DICT ", 1)[1].splitlines()[0])
    classes = model.class_names
    missing = [c for c in classes if f"{c}_3d/moderate_R40" not in ap_dict]
    log(f"[pointrcnn] tools.test: {res['num_frames']} frames in {res['eval_batches']} "
        f"batches, {res['sec_per_example']:.4f} s/frame, {seconds:.2f} s in all, {txts} KITTI "
        f"txts, kernel launches {json.dumps(launches)}; 3D moderate R40 "
        f"{ {c: round(ap_dict.get(f'{c}_3d/moderate_R40', -1), 2) for c in classes} }")
    if missing or len(classes) != 8 or txts != CLI_VAL_FRAMES:
        fail(f"tools.test with {POINTRCNN_CLI_CFG}: AP_DICT lacks {missing} of {classes}; "
             f"{txts} txts for {CLI_VAL_FRAMES} val frames")
    if launches["iou_bev_overlap"] != POINTRCNN_B1_PER_BATCH * res["eval_batches"] or \
            launches["gather_gemm"]:
        fail(f"tools.test with {POINTRCNN_CLI_CFG}: kernel launches {launches}, not B1 "
             f"{POINTRCNN_B1_PER_BATCH} times per eval batch ({res['eval_batches']}) and B2 "
             f"never")
    return {"seconds": seconds, "sec_per_example": res["sec_per_example"],
            "eval_batches": res["eval_batches"], "num_frames": res["num_frames"], "txts": txts,
            "launches": launches,
            "ap_3d_moderate_R40": {c: ap_dict[f"{c}_3d/moderate_R40"] for c in classes}}


def pointrcnn_phase(device, card):
    """Phase 10: PointRCNN (pointrcnn_nuscenes2kitti, full widths, seeded
    weights) on phase 7's synthetic root in a temporary working directory
    whose cfgs/ links to tools/cfgs/. Returns (summary, serving launches,
    tools.test launches, the served request's overlap entries)."""
    import os

    from dfu3d_tpu_torch.core.geometry import iou_kernel
    from dfu3d_tpu_torch.flagship import seeded_weights_
    from dfu3d_tpu_torch.zoo import pointrcnn, pointrcnn_batches

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as work:
        work = Path(work)
        (work / "cfgs").symlink_to(REPO / "tools" / "cfgs")
        os.chdir(work)
        try:
            t0 = time.perf_counter()
            root, _, _ = synthetic_kitti_root(work, flagship_on(work / "train_28130").CLASS_NAMES)
            cfg, _, model = pointrcnn(device=device)
            seeded_weights_(model, seed=0)
            # the 16 train frames, read in test mode: sample_points to 16,384
            batches = pointrcnn_batches(
                cfg, root, root / "nuscenes2kitti_infos_train_28130_initial_pseudo_box.pkl",
                POINTRCNN_REQUESTS)
            seconds = {"setup": time.perf_counter() - t0}
            log(f"[pointrcnn] {sum(p.numel() for p in model.parameters())} parameters; "
                f"{POINTRCNN_REQUESTS} requests of B=4 x {batches[0].points.shape[1]} points from "
                f"phase 7's root, gt per frame {[b.gt_valid.sum(1).tolist() for b in batches]}, "
                f"set-up {seconds['setup']:.2f} s")

            def timed(name, fn, *args):
                t = time.perf_counter()
                out = fn(*args)
                seconds[name] = time.perf_counter() - t
                return out

            res, launches, ms, kept = timed("serve", pointrcnn_serve, model, batches, device)
            profile = timed("profile", pointrcnn_profile, model, batches, device)
            served = timed("b1_served", time_served_overlaps, "pointrcnn", model, batches[0],
                           device, POINTRCNN_OVERLAPS)
            check = timed("fp32_check", check_paths, "pointrcnn", model, cfg, batches[0],
                          res.preds[0], [(iou_kernel, "overlap_bev", "overlap_bev_plain")],
                          device)
            cli_eval = timed("tools_test", pointrcnn_cli, work, root, model, device)
            log(f"[pointrcnn] seconds by step "
                f"{json.dumps({k: round(v, 2) for k, v in seconds.items()})}")
        finally:
            os.chdir(cwd)
    summary = {
        "config": POINTRCNN_CLI_CFG.replace("cfgs/", "tools/cfgs/", 1),
        "workload": "B=4 frames of phase 7's synthetic root (train split, test-mode "
                    "processors: sample_points to 16384), bf16 autocast, seeded weights",
        "card": card, "ms_per_request": {"median": statistics.median(ms), "all": ms},
        "kept_per_frame": kept, "recall": res.metric, "launches": launches, **profile,
        "b1_served": [{k: e[k] for k in ("problem", "shape", "ms", "plain_ms", "bound_ms",
                                          "bound_by", "survivor_share", "overlapping_share")}
                      for e in served],
        "fp32_kernel_vs_plain": check, "tools_test": cli_eval, "phase_seconds": seconds}
    return summary, launches, cli_eval["launches"], served


POINTRCNN_TRAIN_STEPS = 5
POINTRCNN_TRAIN_B1 = 2       # proposal NMS, RoI target IoU
POINTRCNN_TRAIN_OVERLAPS = ("proposal_nms", "roi_target_iou")
POINTRCNN_UNIFORMS_SEED = 0  # the fp32 check's RoI sampler draws


def pointrcnn_train_overlaps(model, batch, device):
    """Each of one bf16 train step's B1 calls (the proposal NMS over
    (4, 4096, 4096), the RoI targets' 3D IoU over (4, 128, G)), recorded
    from a forward in train mode, held against the plain twin on its own
    inputs (fatal on a miss) and timed beside its bound. The model's weights
    and BN statistics are put back."""
    import torch

    from dfu3d_tpu_torch.core.geometry import iou_kernel
    from dfu3d_tpu_torch.train.train_state import SAMPLER_SEED, step_generator

    weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    calls, kernel_fn = [], iou_kernel.overlap_bev

    def recording(ca, cb):
        calls.append((ca, cb))
        return kernel_fn(ca, cb)

    iou_kernel.overlap_bev = recording
    try:
        model.train()
        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
            model(batch.to(device), sampler=step_generator(device, SAMPLER_SEED, 0))
    finally:
        iou_kernel.overlap_bev = kernel_fn
        model.load_state_dict(weights)
    torch.cuda.synchronize()
    if len(calls) != POINTRCNN_TRAIN_B1:
        fail(f"one PointRCNN train forward made {len(calls)} B1 calls, not "
             f"{POINTRCNN_TRAIN_B1} ({', '.join(POINTRCNN_TRAIN_OVERLAPS)})")
    entries = []
    for name, (ca, cb) in zip(POINTRCNN_TRAIN_OVERLAPS, calls):
        got = iou_kernel.overlap_bev(ca, cb)
        torch.cuda.synchronize()
        entry, culled = overlap_agreement(f"pointrcnn train {name}", ca, cb, got)
        entry = {"path": "pointrcnn_train", "problem": name, **entry}
        entries.append(time_overlap(entry, ca, cb, got, culled, reps=10))
        log(overlap_line(f"pointrcnn train {name}", entry))
    return entries


def check_pointrcnn_train_paths(model, batch, device):
    """One fp32 PointRCNN train step (loss and gradients, no update) through
    B1 and the same step through its plain twin, from the same weights and
    the same RoI uniforms. The sampled RoI indices must be equal and the
    loss within TRAIN_LOSS_TOL relative. B1 has no backward: it enters only
    the NMS keep decisions, the targets' IoUs and the soft class labels
    made of them. The batch carries gt made of the model's own proposals
    (`zoo.proposal_gt`), so that RoIs lie on both sides of every threshold
    and the reg and corner losses carry gradient. Each gradient leaf must be within
    TRAIN_GRAD_TOL of its
    largest entry or, where the card's own rounding moves it more, within
    4x the difference between two runs of the step through B1 (the
    gathers' backward adds with atomics, in no fixed order)."""
    import torch

    from dfu3d_tpu_torch.core.geometry import iou_kernel
    from dfu3d_tpu_torch.models import roi_head
    from dfu3d_tpu_torch.zoo import proposal_gt

    weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    batch = proposal_gt(model, batch.to(device))
    gen = torch.Generator(device=device).manual_seed(POINTRCNN_UNIFORMS_SEED)
    p = model.train_proposal_nms["post_max"]
    uniforms = torch.rand((batch.points.shape[0], 2, p), generator=gen, device=device)
    sampled, fg, targets_fn = [], [], roi_head.assign_roi_targets

    def recording(*a, **k):
        out = targets_fn(*a, **k)
        sampled.append(out["sampled_idx"].clone())
        fg.append(int(out["reg_valid_mask"].sum()))
        return out

    def step(plain):
        roi_head.assign_roi_targets = recording
        try:
            with plain_twins([(iou_kernel, "overlap_bev", "overlap_bev_plain")] if plain else []):
                model.load_state_dict(weights)
                model.train()
                model.zero_grad(set_to_none=True)
                loss, _ = model(batch, roi_uniforms=uniforms)
                loss.backward()
                torch.cuda.synchronize()
        finally:
            roi_head.assign_roi_targets = targets_fn
        return loss.item(), {k: q.grad.detach().clone() for k, q in model.named_parameters()}

    k_loss, k_grads = step(False)
    p_loss, p_grads = step(True)
    _, r_grads = step(False)
    model.load_state_dict(weights)
    model.zero_grad(set_to_none=True)
    if not (torch.equal(sampled[0], sampled[1]) and torch.equal(sampled[0], sampled[2])):
        fail(f"PointRCNN fp32 train step: the sampled RoIs differ between B1 and its plain twin "
             f"({int((sampled[0] != sampled[1]).sum())} slots)")
    rel = abs(k_loss - p_loss) / abs(p_loss)
    leaves = []
    for key, pg in p_grads.items():
        scale = pg.abs().max().item()
        if not torch.isfinite(k_grads[key]).all() or not scale > 0:
            fail(f"PointRCNN fp32 train step: gradient {key} not finite or all zero")
        err = (k_grads[key] - pg).abs().max().item() / scale
        spread = (r_grads[key] - k_grads[key]).abs().max().item() / scale
        leaves.append((err / max(TRAIN_GRAD_TOL, 4 * spread), key, err, spread))
    leaves.sort(reverse=True)
    within = sum(err <= TRAIN_GRAD_TOL for _, _, err, _ in leaves)
    log(f"[pointrcnn_train] fp32 train step: loss through B1 {k_loss:.6f}, through the plain "
        f"twin {p_loss:.6f} ({rel:.2e} relative); sampled RoIs equal ({sampled[0].numel()}, "
        f"{fg[0]} over REG_FG_THRESH); "
        f"{within} of {len(leaves)} gradient leaves within {TRAIN_GRAD_TOL:g} of their largest "
        f"entry; worst leaves (B1 - plain, B1 run to run, of the leaf's largest entry): "
        + ", ".join(f"{key} {err:.2e} / {spread:.2e}" for _, key, err, spread in leaves[:5]))
    if not rel <= TRAIN_LOSS_TOL or leaves[0][0] > 1.0:
        fail(f"PointRCNN fp32 train step: B1 vs plain twin differ (loss {rel:.3g} relative, "
             f"gradient {leaves[0][1]} {leaves[0][2]:.3g} of its largest entry where two runs "
             f"through B1 differ by {leaves[0][3]:.3g})")
    return {"loss_rel_err": rel, "sampled_rois_equal": True, "fg_rois": fg[0],
            "leaves_within_tol": within,
            "leaves": len(leaves),
            "worst": [{"leaf": key, "b1_vs_plain": err, "b1_run_to_run": spread}
                      for _, key, err, spread in leaves[:5]]}


def pointrcnn_train_profile(model, state, batches, device):
    """Where a train step's time goes: profile_serve.pointrcnn_profile with
    the optimizer (what `profile_train --model pointrcnn` reports: the spans'
    exclusive ms, the FPS share, the keep-scan's iterations) over the
    batches, and the card's busy and idle share over one step
    (torch.profiler)."""
    import torch

    from dfu3d_tpu_torch import profile_serve
    from dfu3d_tpu_torch.train.train_state import make_train_step

    step = make_train_step(model, state.optimizer, device=device, dtype=torch.bfloat16)
    def run(batch):
        return float(step(batch)["loss"])

    out = profile_serve.pointrcnn_profile(model, run, batches, state.optimizer)
    out["device_time"] = defer_device_profile("pointrcnn_train", lambda: run(batches[0]))
    ph = out["phase_ms"]
    log(f"[pointrcnn_train] instrumented step {ph['step']:.2f} ms: FPS {out['fps_ms']:.2f} ms "
        f"({out['fps_share']:.1%}), backward {ph.get('backward', 0.0):.2f}, clip + optimizer "
        f"{ph.get('clip_optimizer', 0.0):.2f}, point targets {ph.get('point_targets', 0.0):.2f}, "
        f"RoI targets {ph.get('roi_targets', 0.0):.2f} (B1 {ph.get('roi_targets.b1', 0.0):.2f}), "
        f"proposal layer {ph.get('proposal_layer', 0.0):.2f} (B1 "
        f"{ph.get('proposal_layer.b1', 0.0):.2f}, keep-scan "
        f"{ph.get('proposal_layer.keep_scan', 0.0):.2f}); keep-scan iterations "
        f"{[c['iterations'] for c in out['keep_scan']]}")
    return out


def pointrcnn_train_cli(root, device):
    """tools.train with the PointRCNN config for 1 epoch on the train split
    (CLI_TRAIN_FRAMES frames, B=4), then tools.test --ckpt of its checkpoint
    on the val split: fatal on a non-finite loss, no checkpoint, B1 other
    than POINTRCNN_TRAIN_B1 times per train step or POINTRCNN_B1_PER_BATCH
    times per eval batch, any B2 launch, or an AP_DICT without the 8
    classes."""
    from dfu3d_tpu_torch.tools import test as test_cli, train as train_cli

    common = ["--cfg_file", POINTRCNN_CLI_CFG, "--workers", str(LOADER_WORKERS), "--extra_tag",
              "chip_smoke_train"]
    data_path = ["--set", "DATA_CONFIG.DATA_PATH", str(root)]
    reset_launches()
    t0 = time.perf_counter()
    trained = train_cli.main([*common, "--epochs", "1", "--fix_random_seed", *data_path])
    train_s = time.perf_counter() - t0
    train_launches = read_launches()
    (epoch,) = trained["epochs"]
    ckpt = trained["ckpt_dir"] / "checkpoint_epoch_1.pth"
    log(f"[pointrcnn_train] tools.train: {epoch['steps']} steps, losses "
        f"{[round(v, 4) for v in epoch['losses']]}, {epoch['batch_time'] / max(epoch['steps'], 1) * 1e3:.1f} "
        f"ms per step host clock, data_time {epoch['data_time']:.3f} s, {train_s:.2f} s in all; "
        f"kernel launches {json.dumps(train_launches)}")
    if not epoch["steps"] or not all(math.isfinite(v) for v in epoch["losses"]):
        fail(f"tools.train with {POINTRCNN_CLI_CFG}: a loss is not finite or no step ran: {epoch}")
    if not ckpt.exists():
        fail(f"tools.train with {POINTRCNN_CLI_CFG} wrote no {ckpt}")
    if train_launches["iou_bev_overlap"] != POINTRCNN_TRAIN_B1 * epoch["steps"] or \
            train_launches["gather_gemm"]:
        fail(f"tools.train with {POINTRCNN_CLI_CFG}: kernel launches {train_launches}, not B1 "
             f"{POINTRCNN_TRAIN_B1} times per step ({epoch['steps']}) and B2 never")
    reset_launches()
    t0 = time.perf_counter()
    ((_, result_dir, res),) = test_cli.main([*common, "--ckpt", str(ckpt), "--save_to_file",
                                             *data_path])
    test_s = time.perf_counter() - t0
    eval_launches = read_launches()
    txts = len(list((result_dir / "final_result" / "data").glob("*.txt")))
    log_file = next((trained["output_dir"] / "eval").glob("log_eval_*.txt"))
    ap_dict = json.loads(log_file.read_text().split("AP_DICT ", 1)[1].splitlines()[0])
    classes = [c for c in ap_dict if c.endswith("_3d/moderate_R40")]
    log(f"[pointrcnn_train] tools.test --ckpt {ckpt.name}: {res['num_frames']} frames in "
        f"{res['eval_batches']} batches, {res['sec_per_example']:.4f} s/frame, {txts} KITTI "
        f"txts, {test_s:.2f} s in all; kernel launches {json.dumps(eval_launches)}; 3D moderate "
        f"R40 { {c.split('_3d')[0]: round(ap_dict[c], 2) for c in classes} }")
    if len(classes) != 8 or txts != CLI_VAL_FRAMES:
        fail(f"tools.test --ckpt of the trained PointRCNN: AP_DICT holds {classes}, not 8 "
             f"classes; {txts} txts for {CLI_VAL_FRAMES} val frames")
    if eval_launches["iou_bev_overlap"] != POINTRCNN_B1_PER_BATCH * res["eval_batches"] or \
            eval_launches["gather_gemm"]:
        fail(f"tools.test --ckpt of the trained PointRCNN: kernel launches {eval_launches}, not "
             f"B1 {POINTRCNN_B1_PER_BATCH} times per eval batch ({res['eval_batches']}) and B2 "
             f"never")
    return ({"train": {**epoch, "ms_per_step": epoch["batch_time"] / epoch["steps"] * 1e3,
                       "seconds": train_s, "launches": train_launches},
             "eval": {"sec_per_example": res["sec_per_example"],
                      "eval_batches": res["eval_batches"], "num_frames": res["num_frames"],
                      "txts": txts, "seconds": test_s, "launches": eval_launches,
                      "ap_3d_moderate_R40": {c: ap_dict[c] for c in classes}}},
            train_launches, eval_launches)


def pointrcnn_train_phase(device, card):
    """Phase 11: PointRCNN training (pointrcnn_nuscenes2kitti, full widths,
    seeded weights) on phase 7's synthetic root in a temporary working
    directory whose cfgs/ links to tools/cfgs/. Returns (summary, train
    launches, tools.train launches, tools.test launches, the train step's
    B1 entries)."""
    import os

    import torch

    from dfu3d_tpu_torch.utils.config import CfgDict, cfg_from_yaml_file
    from dfu3d_tpu_torch.zoo import POINTRCNN_CFG, pointrcnn, pointrcnn_batches, proposal_gt

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as work:
        work = Path(work)
        (work / "cfgs").symlink_to(REPO / "tools" / "cfgs")
        os.chdir(work)
        try:
            t0 = time.perf_counter()
            root, _, _ = synthetic_kitti_root(work, flagship_on(work / "train_28130").CLASS_NAMES)
            cfg = cfg_from_yaml_file(POINTRCNN_CFG, CfgDict())
            # the train split read in train mode: gt sampling, flip, rotation,
            # scaling, translation, then sample_points to 16,384 and shuffle
            batches = pointrcnn_batches(
                cfg, root, root / "nuscenes2kitti_infos_train_28130_initial_pseudo_box.pkl",
                POINTRCNN_TRAIN_STEPS, training=True)
            seconds = {"setup": time.perf_counter() - t0}
            log(f"[pointrcnn_train] {POINTRCNN_TRAIN_STEPS} batches of B=4 x "
                f"{batches[0].points.shape[1]} points read in train mode from phase 7's root, "
                f"gt per frame {[b.gt_valid.sum(1).tolist() for b in batches]}, set-up "
                f"{seconds['setup']:.2f} s")

            def timed(name, fn, *args):
                t = time.perf_counter()
                out = fn(*args)
                seconds[name] = time.perf_counter() - t
                return out

            built = []

            def build(device, train):
                out = pointrcnn(device=device, train=train)
                built.append(out[2])
                return out

            def with_gt():
                # each batch's proposal gt from the model as its step finds it
                for batch in batches:
                    yield proposal_gt(built[0], batch, torch.bfloat16)

            model, launches, steps, state = timed("train", train, "pointrcnn", build,
                                                  with_gt(), device)
            no_fg = [s["it"] for s in steps if not s["rcnn_reg_loss"] > 0]
            if no_fg:
                fail(f"PointRCNN train steps {no_fg} had no RoI over REG_FG_THRESH "
                     "(rcnn_reg_loss 0): the RoI head's reg branch got no gradient")
            bad = [s["it"] for s in steps if s["iou_bev_overlap"] != POINTRCNN_TRAIN_B1
                   or s["gather_gemm"]]
            if bad or launches["iou_bev_overlap"] != POINTRCNN_TRAIN_B1 * len(steps) or \
                    launches["gather_gemm"]:
                fail(f"PointRCNN train steps {bad} did not launch B1 exactly "
                     f"{POINTRCNN_TRAIN_B1} times and B2 never: {launches}")
            gt_batch = proposal_gt(model, batches[0], torch.bfloat16)
            b1 = timed("b1_train", pointrcnn_train_overlaps, model, gt_batch, device)
            check = timed("fp32_check", check_pointrcnn_train_paths, model, batches[0], device)
            profile = timed("profile", pointrcnn_train_profile, model, state,
                            [proposal_gt(model, b, torch.bfloat16) for b in batches[:3]], device)
            del model, state
            cli, cli_train, cli_eval = timed("cli", pointrcnn_train_cli, root, device)
            log(f"[pointrcnn_train] seconds by step "
                f"{json.dumps({k: round(v, 2) for k, v in seconds.items()})}")
        finally:
            os.chdir(cwd)
    ms = [s["host_ms"] for s in steps]
    summary = {
        "config": POINTRCNN_CLI_CFG.replace("cfgs/", "tools/cfgs/", 1),
        "workload": "B=4 frames of phase 7's synthetic root (train split, train mode: gt "
                    "sampling and world augmentations, sample_points to 16384), bf16 autocast, "
                    "seeded weights, adam_onecycle over 1000 steps",
        "card": card, "steps": steps,
        "ms_per_step": {"median": statistics.median(ms), "all": ms},
        "samples_per_s": 4 / (statistics.median(ms) / 1e3), "launches": launches,
        "rcnn_reg_loss_per_step": [s["rcnn_reg_loss"] for s in steps], **profile,
        "b1_train": [{k: e[k] for k in ("problem", "shape", "ms", "plain_ms", "bound_ms",
                                         "bound_by", "survivor_share", "overlapping_share")}
                     for e in b1],
        "fp32_b1_vs_plain": check, "cli": cli, "phase_seconds": seconds}
    return summary, launches, cli_train, cli_eval, b1


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    sys.path.insert(0, str(REPO))
    try:
        from dfu3d_tpu_torch import cuda_build
        from dfu3d_tpu_torch.core.geometry import iou_kernel
        from dfu3d_tpu_torch.core.voxel import gather_gemm_kernel
        from dfu3d_tpu_torch.data.batch import synthetic_batch
        from dfu3d_tpu_torch.data import kitti_io
        from dfu3d_tpu_torch.eval import native
        from dfu3d_tpu_torch.flagship import flagship, seeded_weights_
        from dfu3d_tpu_torch.zoo import voxel_centerpoint
    except ImportError as e:
        fail(f"the dfu3d_tpu_torch package is not next to chip_smoke.py ({e})")

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"[device] {kind} x{count}, torch {torch.__version__}, CUDA {torch.version.cuda}; "
        "TF32 off for the fp32 comparisons")
    device = torch.device("cuda")

    # 2. build, one nvcc per source, all at once
    t0 = time.perf_counter()
    libs = cuda_build.build((iou_kernel.SOURCE, iou_kernel.NVCC_FLAGS),
                            (gather_gemm_kernel.SOURCE, gather_gemm_kernel.NVCC_FLAGS))
    log(f"[build] {', '.join(str(lib.relative_to(REPO)) for lib in libs)} in "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    native.get_lib()
    log(f"[build] the native KITTI matcher {native.library_path().relative_to(REPO)} (g++) in "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    kitti_io.png_unfilter_lib()
    log(f"[build] the native PNG unfilter (g++) in {time.perf_counter() - t0:.2f} s")

    # 3. kernels vs plain
    iou_shapes, iou_err = check_overlap_kernel(device)
    gemm_shapes = check_gather_gemm_kernel(device)

    # 4 and 5 for each path
    batches = [synthetic_batch(4, 60000, 256, 50.0, seed=s) for s in range(4)]
    cfg, grid, pillar = flagship(device=device)
    seeded_weights_(pillar, seed=0)
    nx, ny, _ = grid.grid_size
    log(f"[serve] CenterPoint-pillar {nx}x{ny} BEV, {len(batches)} batches of B=4, 60000 "
        f"points, 256 gt slots (16 valid), bf16 autocast")
    res, pillar_launches = serve("pillar", pillar, batches, device)
    for k, batch in enumerate(batches):
        distinct, kept = pillar_counts(batch, grid, pillar.vfe.max_pillars)
        log(f"[serve] pillar batch {k}: pillars per sample {distinct}, kept {kept}, dropped "
            f"{[d - p for d, p in zip(distinct, kept)]}")
    if pillar_launches["iou_bev_overlap"] <= 0:
        fail("the pillar serving run did not launch the overlap kernel")
    served_iou = time_served_overlaps("pillar", pillar, batches[0], device)
    check_paths("pillar", pillar, cfg, batches[0], res.preds[0],
                [(iou_kernel, "overlap_bev", "overlap_bev_plain")], device)
    del pillar, res

    vcfg, vgrid, voxel = voxel_centerpoint(device=device)
    seeded_weights_(voxel, seed=0)
    log(f"[serve] voxel CenterPoint {'x'.join(map(str, vgrid.grid_size))} grid, "
        f"max_voxels {voxel.vfe.max_voxels}, {len(batches)} batches of B=4, 60000 points, "
        f"bf16 autocast")
    res, voxel_launches = serve("voxel", voxel, batches, device)
    stages = voxel_stages(voxel, batches[0], device)
    if voxel_launches["gather_gemm"] != 21 * len(batches):
        fail(f"the voxel serving run launched the gather-GEMM kernel "
             f"{voxel_launches['gather_gemm']} times, not 21 per batch")
    if voxel_launches["gather_gemm_tensor_core"] != 21 * len(batches):
        fail(f"the bf16 voxel serving run launched the tensor-core gather-GEMM "
             f"{voxel_launches['gather_gemm_tensor_core']} times, not 21 per batch")
    if voxel_launches["iou_bev_overlap"] <= 0:
        fail("the voxel serving run did not launch the overlap kernel")
    served_total, served_gemms = time_served_gemms(voxel, batches[0], device)
    served_iou += time_served_overlaps("voxel", voxel, batches[0], device)
    check_paths("voxel", voxel, vcfg, batches[0], res.preds[0],
                [(iou_kernel, "overlap_bev", "overlap_bev_plain"),
                 (gather_gemm_kernel, "gather_gemm", "gather_gemm_plain")], device)
    del voxel, res

    # 6. train
    swaps = [(iou_kernel, "overlap_bev", "overlap_bev_plain"),
             (gather_gemm_kernel, "gather_gemm", "gather_gemm_plain")]
    train_batches = [synthetic_batch(4, 60000, 256, 50.0, seed=s) for s in range(TRAIN_STEPS)]
    model, pillar_train, pillar_steps, _ = train("pillar", flagship, train_batches, device)
    train_checks = {"pillar": check_train_paths("pillar", model, train_batches[0], swaps,
                                                device)}
    del model
    train_batches = [synthetic_batch(4, 60000, 256, 50.0, seed=s, velocity=True)
                     for s in range(TRAIN_STEPS)]
    model, voxel_train, voxel_steps, _ = train("voxel", voxel_centerpoint, train_batches, device)
    bad = [s for s in voxel_steps if s["gather_gemm_tensor_core"] != VOXEL_TRAIN_B2
           or s["gather_gemm_cuda_core"] != 0]
    if bad or voxel_train["gather_gemm"] != VOXEL_TRAIN_B2 * TRAIN_STEPS:
        fail(f"a voxel train step did not launch the tensor-core gather-GEMM exactly "
             f"{VOXEL_TRAIN_B2} times: {bad or voxel_train}")
    if pillar_train["gather_gemm"] or pillar_train["iou_bev_overlap"] or \
            voxel_train["iou_bev_overlap"]:
        fail(f"a train path launched a kernel that is not on it: pillar {pillar_train}, "
             f"voxel {voxel_train}")
    dx_total, dx_entries = time_train_dx(model, train_batches[0], device)
    train_checks["voxel"] = check_train_paths("voxel", model, train_batches[0], swaps, device)
    del model

    # 7. the flagship from disk through the CLIs
    pillar_step_ms = statistics.median(s["host_ms"] for s in pillar_steps)
    cli_summary, cli_train, cli_eval = cli(device, pillar_step_ms)

    # 8. pipeline 2: depth completion and the pseudo-box factory through their CLIs
    pseudo_summary, pseudo_launches = pseudo(device)

    # 9. pipelines 1 and 4: nuScenes -> KITTI, self-evolution, the synthetic run
    evolve_summary, evolve_launches, v8_served, v8_dx = evolve_phase(device)
    ev_iou = sum(v["iou_bev_overlap"] for v in evolve_launches.values())

    # 10. PointRCNN serving, in memory and through tools.test
    prcnn_summary, prcnn_launches, prcnn_cli_launches, prcnn_served = pointrcnn_phase(device,
                                                                                      card)
    served_iou += prcnn_served
    prcnn_nms = prcnn_served[0]

    # 11. PointRCNN training, in memory and through tools.train / tools.test
    prcnn_train_summary, prcnn_train, prcnn_cli_train, prcnn_cli_train_eval, prcnn_train_b1 = \
        pointrcnn_train_phase(device, card)

    # the device profiles of phases 10 and 11, after every host-clock reading
    run_deferred_profiles()

    nms_entry = next(e for e in iou_shapes if e["case"] == "nms")
    gemm_timed = [e for e in gemm_shapes if "ms" in e]
    kernels = [{
        "name": "iou_bev_overlap",
        "route": "cuda",
        "source": "dfu3d_tpu_torch/core/geometry/csrc/iou_bev.cu",
        "replaces": "dfu3d_tpu/core/geometry/iou_pallas.py:116",
        "launches": (pillar_launches["iou_bev_overlap"] + voxel_launches["iou_bev_overlap"]
                     + cli_eval["iou_bev_overlap"] + ev_iou + prcnn_launches["iou_bev_overlap"]
                     + prcnn_cli_launches["iou_bev_overlap"] + prcnn_train["iou_bev_overlap"]
                     + prcnn_cli_train["iou_bev_overlap"]
                     + prcnn_cli_train_eval["iou_bev_overlap"]),
        "launches_by_path": {"pillar": pillar_launches["iou_bev_overlap"],
                             "voxel": voxel_launches["iou_bev_overlap"],
                             "pillar_train": pillar_train["iou_bev_overlap"],
                             "voxel_train": voxel_train["iou_bev_overlap"],
                             "cli_train": cli_train["iou_bev_overlap"],
                             "cli_eval": cli_eval["iou_bev_overlap"],
                             "pseudo": pseudo_launches["iou_bev_overlap"],
                             **{k: v["iou_bev_overlap"] for k, v in evolve_launches.items()},
                             "pointrcnn": prcnn_launches["iou_bev_overlap"],
                             "pointrcnn_cli_eval": prcnn_cli_launches["iou_bev_overlap"],
                             "pointrcnn_train": prcnn_train["iou_bev_overlap"],
                             "pointrcnn_cli_train": prcnn_cli_train["iou_bev_overlap"],
                             "pointrcnn_cli_train_eval":
                                 prcnn_cli_train_eval["iou_bev_overlap"]},
        "train_launches_per_step": {"pointrcnn": sorted(
            {st["iou_bev_overlap"] for st in prcnn_train_summary["steps"]})},
        "max_abs_err": max([iou_err] + [e["max_abs_err"]
                                        for e in served_iou + prcnn_train_b1]),
        "ms": nms_entry["ms"],
        "kernel_ms": nms_entry["ms"],
        "plain_ms": nms_entry["plain_ms"],
        "bound_ms": nms_entry["bound_ms"],
        "bound_by": nms_entry["bound_by"],
        "library_ms": None,
        "ops_all_pairs": nms_entry["ops_all_pairs"],
        "bound_all_pairs_ms": nms_entry["bound_all_pairs_ms"],
        "survivor_share": nms_entry["survivor_share"],
        "overlapping_share": nms_entry["overlapping_share"],
        "cull_margin_m": iou_kernel.CULL_MARGIN,
        "shapes": [e["shape"] for e in iou_shapes + served_iou + prcnn_train_b1],
        "per_shape": iou_shapes,
        "served": served_iou,
        "pointrcnn_train": prcnn_train_b1,
        "pointrcnn_proposal_nms": {k: prcnn_nms[k] for k in (
            "shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "ops", "bytes",
            "survivor_share", "overlapping_share", "share_of_bound", "bound_all_pairs_ms")},
    }, {
        "name": "gather_gemm",
        "route": "cuda",
        "source": "dfu3d_tpu_torch/core/voxel/csrc/gather_gemm.cu",
        "replaces": "dfu3d_tpu/core/voxel/pallas_sparse.py:77",
        "launches": (voxel_launches["gather_gemm"] + voxel_train["gather_gemm"]
                     + sum(v["gather_gemm"] for v in evolve_launches.values())),
        "launches_by_path": {"voxel": voxel_launches["gather_gemm"],
                             "voxel_train": voxel_train["gather_gemm"],
                             "pillar_train": pillar_train["gather_gemm"],
                             "cli_train": cli_train["gather_gemm"],
                             "cli_eval": cli_eval["gather_gemm"],
                             "pseudo": pseudo_launches["gather_gemm"],
                             **{k: v["gather_gemm"] for k, v in evolve_launches.items()},
                             "pointrcnn": prcnn_launches["gather_gemm"],
                             "pointrcnn_cli_eval": prcnn_cli_launches["gather_gemm"],
                             "pointrcnn_train": prcnn_train["gather_gemm"],
                             "pointrcnn_cli_train": prcnn_cli_train["gather_gemm"],
                             "pointrcnn_cli_train_eval": prcnn_cli_train_eval["gather_gemm"]},
        "launches_by_variant": {k: voxel_launches[f"gather_gemm_{k}"]
                                + voxel_train[f"gather_gemm_{k}"]
                                + sum(v[f"gather_gemm_{k}"] for v in evolve_launches.values())
                                for k in ("tensor_core", "cuda_core")},
        "train_launches_per_step": {"forward": 21, "dx": VOXEL_TRAIN_B2 - 21},
        "instruction_by_variant": {
            "tensor_core": "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 (bf16)",
            "cuda_core": "fmaf (fp32)"},
        "max_abs_err": max(e["max_abs_err"] for e in gemm_shapes if e["dtype"] == "float32"),
        "max_abs_err_bf16": max(e["max_abs_err"] for e in gemm_shapes if e["dtype"] == "bfloat16"),
        "unit": "one served bf16 request: its 21 launches on their own tables, summed",
        "ms": served_total["ms"],
        "kernel_ms": served_total["ms"],
        "plain_ms": served_total["plain_ms"],
        "bound_ms": served_total["bound_ms"],
        "bound_by": served_total["bound_by"],
        "library_ms": served_total["library_ms"],
        "library": "index_select of B*Q*K rows + one matmul contracting K*Cin (2 calls)",
        "random_tables_step": {
            k: sum(e[k] * e["launches_per_step"] for e in gemm_timed)
            for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
        "shapes": [e["shape"] for e in gemm_shapes],
        "per_shape": gemm_shapes,
        "served_request": served_gemms,
        "voxel_stages": stages,
        "train_dx": {"unit": "one bf16 voxel train step: its 20 dX launches on their own "
                             "inputs, summed", **dx_total, "per_conv": dx_entries},
        "voxel8x": {
            "model": "e2e_synthetic --model voxel (MeanVFE + VoxelBackBone8x), bf16",
            "train_launches_per_step": {"forward": 12, "dx": VOXEL8X_TRAIN_B2 - 12},
            "shapes": [e["shape"] for e in v8_served[1] + v8_dx[1]],
            "served_request": {"unit": "one served bf16 request: its 12 launches, summed",
                               **v8_served[0], "per_conv": v8_served[1]},
            "train_dx": {"unit": "one bf16 train step: its 11 dX launches, summed",
                         **v8_dx[0], "per_conv": v8_dx[1]}},
    }]
    log(json.dumps({"train": {"pillar": {"steps": pillar_steps, "launches": pillar_train},
                              "voxel": {"steps": voxel_steps, "launches": voxel_train},
                              "fp32_kernels_vs_plain": train_checks}}))
    log(json.dumps({"cli": cli_summary}, default=str))
    log(json.dumps({"pseudo": pseudo_summary}))
    log(json.dumps({"evolve": evolve_summary}, default=str))
    log(json.dumps({"pointrcnn": prcnn_summary}, default=str))
    log(json.dumps({"pointrcnn_train": prcnn_train_summary}, default=str))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
