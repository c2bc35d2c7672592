#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (dfu3d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py              # from the repository root, one card

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
              classes, B1 3 times per eval batch); then one tools.evolve
              --rounds 1 --epochs 1 round on the config over the same root
              (--score_thresh 0, set on MODEL.POST_PROCESSING: the config has
              no dense head), fatal unless B1 runs twice per train step and 3
              times per eval batch, B2 never, label_refine0 is the epoch's
              predictions byte for byte and the rebuilt infos count them.
 12. depth_train  pipeline 2's depth nets trained through tools.train_depth
              on the card, in a temporary directory: ENet, PENetC2, and
              PENetC2 with its backbone frozen, each 9 bf16 steps and a val
              frame of --synthetic frames at 352 x 1216, widths 32-256, B=1;
              fatal on a non-finite loss or metric, a B1 or B2 launch, or a
              tensor left unchanged (under --freeze_backbone the backbone's
              parameters must stay unchanged and its BN statistics change).
              Per run the losses, ms per step (host clock), frames/s and peak
              memory. Then one fp32 PENetC2 step (BN biases +3) on the card,
              on this machine's CPU and in fp64 on the card: losses within
              1e-5 relative, every gradient leaf of the card's step within
              3e-4 of fp64's and of the pairs with the CPU within 2e-3 (of
              the leaf's largest entry, at least 1e-3 of the gradient's),
              BN statistics within 1e-5; the step with TF32 on and in bf16
              must fail those limits; the step's six
              propagations alone, forward and backward, timed with CUDA
              events; pipeline 2 from the trained ENet (tools.depth_e2e over
              phase 8's 8 frames: complete_depth --ckpt, then the factory
              under gt, sparse and completed depth; one label file per
              frame, no kernel launch); device busy, idle and the
              propagations' share of a step from torch.profiler, last.
 13. nuscenes  nuScenes from disk and the anchor detectors, in a temporary
              working directory: data.nuscenes_synthetic writes 16 train + 8
              val key frames, each with 9 sweeps of 34,000 points, 20-40 boxes
              of the ten classes; create_nuscenes_infos(max_sweeps=10) (fatal
              unless every info has 9 sweeps and the gt count is what was
              written); one frame in test mode (5 features, time lags 0-0.45
              s, capped at MAX_POINTS_PER_FRAME). SECOND
              (cbgs_second_multihead at its published widths: 1024 x 1024 x
              40 grid, max_voxels 60,000, AnchorHeadMulti with 327,680
              anchors, NMS 1000 -> 83) with seeded weights: 4 requests of
              B=4 through eval_batches (bf16), fatal unless each launches the
              tensor-core B2 12 times and B1 twice (NMS, recall); each B1 and
              B2 call of one request held against its plain twin and timed;
              one fp32 request through the kernels and through the twins.
              PointPillar multi-head (cbgs_pp_multihead): 2 requests, pillars
              kept and dropped, B1 twice per batch, B2 never. SECOND
              training: 5 bf16 steps through trainer.train_model (train mode:
              class-balanced resampling, flip, rotation, scaling), the loss
              terms, grad_norm, host-clock ms and launches per step; fatal on
              a non-finite loss, a tensor left unchanged, a step without a
              positive anchor or other than 23 tensor-core B2 launches (12
              forward, 11 dX) and no B1; the checkpoint reloaded equal; the
              11 dX launches held against the twin and timed; one fp32 step
              through the kernels against the twins (as phase 6). tools.train
              (1 epoch) and tools.test on cbgs_second_multihead and on
              cbgs_voxel01_res3d_centerpoint from the root, gt sampling off
              (no nuScenes gt database exists): fatal unless each train step
              launches B2 23 (41) times, each eval batch 12 (21) times and B1
              twice, every val frame comes back and the AP_DICT holds the ten
              classes. Last, with the deferred profiles, profile_serve and
              profile_train --model second in processes of their own.
 14. two_stage  SECOND-IoU, Voxel R-CNN, PV-RCNN, PartA2 and PV-RCNN++ on
              their KITTI configs (second_iou, voxel_rcnn_car, pv_rcnn,
              PartA2, pv_rcnn_plusplus) at full width with seeded weights,
              in a temporary working directory: kitti_synthetic
              writes 16 train + 8 val frames of Car, Pedestrian and Cyclist,
              tools.create_infos their infos and gt database. Per model: 4
              requests of B=4 (SECOND-IoU, Voxel R-CNN and PV-RCNN: 2)
              through eval_batches (bf16), fatal unless each
              launches B1 3 times (proposal NMS, final NMS, recall) and the
              tensor-core B2 once per sparse conv (12 for SECOND-IoU and
              PartA2's SparseUNet, 9 for the SparseEncoder of the others);
              each served B1 and B2 call
              held against its twin and timed; one fp32 request through the
              kernels and through the twins. Then the train batches' gt,
              made once from the seeded model's proposals (zoo.proposal_gt,
              its forwards counted on a path of their own); one train
              forward's B1 calls (the proposal NMS at (B, 9000, 9000), the
              RoI targets' 3D IoU) held against the twin, each pair within
              4 ulps of the square of its own largest coordinate, and
              timed; one bf16 step's forward and dX B2 calls counted, the dX
              calls checked to mirror the forwards, held and timed; one fp32
              step through the kernels against the twins with the RoI
              regression branch's gradient nonzero. 5 bf16 steps (the first
              three models: 3) through
              trainer.train_model (B=4, PV-RCNN B=2; gt sampling and the
              world augmentations): fatal on a non-finite loss, a tensor
              left unchanged, a first step without a RoI over REG_FG_THRESH, other
              than 2 B1 and 2 x convs - 1 tensor-core B2 launches, or
              the 99th percentile of its proposals beyond 10 x the
              point-cloud range. Last, Voxel R-CNN and PartA2 through
              tools.train (1 epoch) and tools.test on the root, with their
              launch counts.
The lines before the last are {"cli": {...}}, {"pseudo": {...}},
{"evolve": {...}}, {"pointrcnn": {...}}, {"pointrcnn_train": {...}},
{"depth_train": {...}}, {"nuscenes": {...}}, {"two_stage": {...}} and
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


def overlap_agreement(label, ca, cb, got, tol=KERNEL_TOL):
    """The kernel's output against the plain twin's: within `tol` (a number,
    or a tensor of one tolerance per pair), and exactly 0 (in both) wherever
    the cull predicate culls. Fatal on a miss. Returns (entry, cull mask)."""
    import torch

    from dfu3d_tpu_torch.core.geometry import iou_kernel

    want = iou_kernel.overlap_bev_plain(ca, cb)
    culled = iou_kernel.overlap_bev_cull_plain(ca, cb)
    diff = (got - want).abs()
    err = diff.max().item()
    if not bool((diff <= tol).all()):
        worst = int((diff - tol).argmax())
        tol_at = tol.flatten()[worst].item() if torch.is_tensor(tol) else tol
        fail(f"overlap kernel vs plain on {label} {tuple(got.shape)}: max |diff| {err}, a pair "
             f"off by {diff.flatten()[worst].item():.3g} where its tolerance is {tol_at:.3g}")
    if culled.any() and (got[culled].abs().max().item() != 0.0
                         or want[culled].abs().max().item() != 0.0):
        fail(f"overlap on {label}: a culled pair is not exactly 0 (kernel "
             f"{got[culled].abs().max().item()}, plain {want[culled].abs().max().item()})")
    return {"shape": list(got.shape), "max_abs_err": err}, culled


def time_overlap(entry, ca, cb, got, culled, reps=25, plain_reps=None, warmup=3):
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
        ms=time_ms(lambda: iou_kernel.overlap_bev(ca, cb), reps=reps, warmup=warmup),
        plain_ms=time_ms(lambda: iou_kernel.overlap_bev_plain(ca, cb),
                         reps=plain_reps or max(reps // 5, 3), warmup=warmup),
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
        entry["max_err_over_tol"] = (err / tol).max().item() if err.numel() else 0.0
        entry["share_beyond_1ulp"] = (err > ulp).float().mean().item() if err.numel() else 0.0
    else:
        entry["max_err_over_tol"] = entry["max_abs_err"] / GEMM_TOL
    entry["ok"] = entry["max_err_over_tol"] <= 1.0
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
            + f" ({entry['max_err_over_tol']:.3f} of its tolerance"
            + (f"; {entry['share_beyond_1ulp']:.2e} of the outputs beyond 1 ulp"
               if "share_beyond_1ulp" in entry else "") + ")"
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
    dense_head = cfg.MODEL.get("DENSE_HEAD") or {}
    roi = cfg.MODEL.get("ROI_HEAD") or {}
    thresh = float(dense_head.POST_PROCESSING.NMS_CONFIG.NMS_THRESH
                   if "POST_PROCESSING" in dense_head
                   else roi.NMS_CONFIG.TEST.NMS_THRESH if "NMS_CONFIG" in roi
                   else roi.NMS_THRESH if roi
                   else cfg.MODEL.POST_PROCESSING.NMS_CONFIG.NMS_THRESH)
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
                 max_err_over_tol=max(e["max_err_over_tol"] for e in entries))
    log(f"[kernels] gather_gemm {label} ({len(entries)} launches, all tensor-core, each within "
        f"tolerance of the plain twin, worst error {total['max_err_over_tol']:.3f} of its "
        f"tolerance): kernel "
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
    check_dx_mirrors(GEMM_CONVS, fwd, dx)
    return hold_gemm_calls("dX of one voxel train step", zip(GEMM_CONVS[::-1], dx))


def check_dx_mirrors(convs, fwd, dx):
    """Fatal unless each dX call mirrors its forward call: the backward runs
    the convs (`convs`, forward order) in reverse, with the transposed
    weights, and the first conv's input needs no dX."""
    if len(fwd) != len(convs) or len(dx) != len(convs) - 1:
        fail(f"{len(fwd)} forward and {len(dx)} dX gather-GEMM calls for the {len(convs)} "
             f"convs {convs[0]} ... {convs[-1]}")
    for name, f, args in zip(convs[::-1], fwd[::-1], dx):
        k, cin, cout = f[3].shape
        if tuple(args[3].shape) != (k, cout, cin) or args[0].shape != (f[0].shape[0],
                                                                       f[2].shape[1], cout):
            fail(f"dX launch for {name}: shapes {[tuple(a.shape) for a in args]} do not mirror "
                 f"its forward's {[tuple(a.shape) for a in f]}")


def gather_gemm_plain_reversed(feats, valid, nbr, kernel):
    """The plain twin summing the taps in reverse order: the same function
    with another fp32 rounding (the yardstick of check_train_paths)."""
    from dfu3d_tpu_torch.core.voxel import gather_gemm_kernel as gk

    return gk.gather_gemm_plain(feats, valid, nbr.flip(-1).contiguous(),
                                kernel.flip(0).contiguous())


def check_train_paths(name, model, batch, swaps, device, scales=False):
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
    out = {"loss_rel_err": rel, "leaves_within_tol": within, "leaves": len(leaves),
           "worst": [{"leaf": key, "kernel_vs_plain": err, "plain_vs_reversed": spread}
                     for _, key, err, spread in leaves[:5]]}
    if scales:   # each leaf's largest |entry|
        out["leaf_scales"] = {key: pg.abs().max().item() for key, pg in p_grads.items()}
    return out


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
TRAIN_OVERLAPS = ("proposal_nms", "roi_target_iou")   # a two-stage train step's B1 calls
POINTRCNN_UNIFORMS_SEED = 0  # the fp32 check's RoI sampler draws


def train_overlaps(path, model, batch, device, coord_tol=False):
    """Each of one bf16 train step's B1 calls (the proposal NMS, over (4,
    4096, 4096) for PointRCNN and (B, 9000, 9000) for the two-stage voxel
    detectors; the RoI targets' 3D IoU over (B, R, G)), recorded from a
    forward in train mode, held against the plain twin on its own inputs
    (fatal on a miss) and timed beside its bound (the twin 3 times: at
    (4, 9000, 9000) it takes seconds). With `coord_tol` each pair's
    tolerance is KERNEL_TOL or 4 ulps of the square of the pair's own
    largest |coordinate|, whichever is larger: the shoelace sums' fp32
    rounding grows with the squared coordinates, and some of the two-stage
    proposals reach hundreds of metres, while a pair of boxes within the
    point-cloud range keeps a tolerance near KERNEL_TOL. The model's
    weights and BN statistics are put back."""
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
    if len(calls) != len(TRAIN_OVERLAPS):
        fail(f"one {path} train forward made {len(calls)} B1 calls, not {len(TRAIN_OVERLAPS)} "
             f"({', '.join(TRAIN_OVERLAPS)})")
    entries = []
    for name, (ca, cb) in zip(TRAIN_OVERLAPS, calls):
        got = iou_kernel.overlap_bev(ca, cb)
        torch.cuda.synchronize()
        coord = max(ca.abs().max().item(), cb.abs().max().item())
        tol = KERNEL_TOL
        if coord_tol:
            sa, sb = ca.abs().flatten(2).amax(-1), cb.abs().flatten(2).amax(-1)
            scale = torch.maximum(sa[:, :, None], sb[:, None, :])
            tol = (4 * 2.0 ** -23 * scale * scale).clamp_min(KERNEL_TOL)
            del scale
        entry, culled = overlap_agreement(f"{path} train {name}", ca, cb, got, tol)
        tols = {"tol_max": tol.max().item(),
                "share_of_pairs_over_kernel_tol": (tol > KERNEL_TOL).float().mean().item()} \
            if coord_tol else {"tol_max": tol, "share_of_pairs_over_kernel_tol": 0.0}
        entry = {"path": f"{path}_train", "problem": name, **entry, "max_abs_coord": coord,
                 **tols}
        entries.append(time_overlap(entry, ca, cb, got, culled, reps=10, plain_reps=3, warmup=1))
        del got, culled, tol
        log(overlap_line(f"{path} train {name}", entry) + f"; largest |coordinate| "
            f"{coord:.1f} m, per-pair tolerance up to {tols['tol_max']:.3g} m^2, above "
            f"{KERNEL_TOL:g} m^2 on {tols['share_of_pairs_over_kernel_tol']:.4%} of the pairs")
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


def pointrcnn_evolve(root, device):
    """tools.evolve --rounds 1 --epochs 1 on the PointRCNN config over phase 7's
    root (--score_thresh 0, as phase 9's flagship round, for the same
    reason): the threshold lands on MODEL.POST_PROCESSING, the config has no
    dense head. Kernel counts are set to 0 just before and read just after:
    B1 POINTRCNN_TRAIN_B1 times per train step and POINTRCNN_B1_PER_BATCH
    times per eval batch of the predict pass, B2 never. label_refine0 must be
    the epoch's predictions byte for byte and the rebuilt infos must count
    each frame's labels."""
    import numpy as np

    from dfu3d_tpu_torch.tools import evolve

    reset_launches()
    t0 = time.perf_counter()
    (rec,) = evolve.main(["--cfg_file", POINTRCNN_CLI_CFG, "--rounds", "1", "--epochs", "1",
                          "--score_thresh", "0.0", "--device", device.type, "--set",
                          "DATA_CONFIG.DATA_PATH", str(root)])
    seconds = time.perf_counter() - t0
    launches = read_launches()
    steps = sum(e["steps"] for e in rec["train"]["epochs"])
    batches = sum(res["eval_batches"] for _, _, res in rec["predictions"])
    want_b1 = POINTRCNN_TRAIN_B1 * steps + POINTRCNN_B1_PER_BATCH * batches
    if not steps or launches["iou_bev_overlap"] != want_b1 or launches["gather_gemm"]:
        fail(f"tools.evolve on {POINTRCNN_CLI_CFG}: kernel launches {launches}, not B1 "
             f"{POINTRCNN_TRAIN_B1} per train step ({steps}) and {POINTRCNN_B1_PER_BATCH} per "
             f"eval batch ({batches}), B2 never")
    newest = rec["prediction_dir"]
    labels = sorted(rec["label_dir"].glob("*.txt"))
    if len(labels) != CLI_TRAIN_FRAMES or \
            [p.name for p in labels] != sorted(p.name for p in newest.glob("*.txt")) or any(
            p.read_bytes() != (newest / p.name).read_bytes() for p in labels):
        fail(f"{rec['label_dir']} is not a copy of the round's {CLI_TRAIN_FRAMES} prediction "
             f"files {newest}")
    infos = np.load(rec["next_info"], allow_pickle=True)
    counts = {i["point_cloud"]["lidar_idx"]: len(i["annos"]["name"]) for i in infos}
    lines = {p.stem: len(p.read_text().splitlines()) for p in labels}
    if counts != lines or not sum(lines.values()):
        fail(f"the rebuilt PointRCNN infos count {counts} boxes where label_refine0 holds {lines}")
    log(f"[pointrcnn_train] tools.evolve --rounds 1 --epochs 1 ({POINTRCNN_CLI_CFG}, "
        f"{CLI_TRAIN_FRAMES} frames): {seconds:.2f} s "
        f"({json.dumps({k: round(v, 3) for k, v in rec['seconds'].items()})}); {steps} train "
        f"steps, {batches} eval batches, kernel launches {json.dumps(launches)}; "
        f"{rec['label_dir'].name} = the epoch's predictions, {sum(lines.values())} boxes, "
        f"{rec['next_info'].name} counts the same per frame")
    return ({"seconds": seconds, "split_s": rec["seconds"], "train_steps": steps,
             "eval_batches": batches, "launches": launches, "boxes": sum(lines.values()),
             "label_dir": rec["label_dir"].name, "next_info": rec["next_info"].name},
            launches)


def pointrcnn_train_phase(device, card):
    """Phase 11: PointRCNN training (pointrcnn_nuscenes2kitti, full widths,
    seeded weights) on phase 7's synthetic root in a temporary working
    directory whose cfgs/ links to tools/cfgs/. Returns (summary, train
    launches, tools.train launches, tools.test launches, the train step's
    B1 entries, the tools.evolve round's launches)."""
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
            b1 = timed("b1_train", train_overlaps, "pointrcnn", model, gt_batch, device)
            check = timed("fp32_check", check_pointrcnn_train_paths, model, batches[0], device)
            profile = timed("profile", pointrcnn_train_profile, model, state,
                            [proposal_gt(model, b, torch.bfloat16) for b in batches[:3]], device)
            del model, state
            cli, cli_train, cli_eval = timed("cli", pointrcnn_train_cli, root, device)
            evolve_round, evolve_launches = timed("evolve", pointrcnn_evolve, root, device)
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
        "fp32_b1_vs_plain": check, "cli": cli, "evolve": evolve_round,
        "phase_seconds": seconds}
    return summary, launches, cli_train, cli_eval, b1, evolve_launches


DEPTH_TRAIN_FRAMES = 10   # tools.train_depth --synthetic: 9 train steps and 1 val frame per run
DEPTH_TRAIN_RUNS = (("enet", ["--model", "enet"]), ("penet_c2", ["--model", "penet_c2"]),
                    ("penet_c2_frozen", ["--model", "penet_c2", "--freeze_backbone"]))
DEPTH_HW = (352, 1216)    # the train CLI's --height / --width defaults
# the fp32 PENetC2 step on the card vs the CPU, BN biases +3 (ReLU inputs
# away from 0, as phase 6; without the shift, ReLU kinks moved leaves by up
# to 0.44 % between fp32 and fp64 on the CPU at 88 x 304), with the same step
# in fp64 on the card as the reference of both. Each gradient leaf's error is
# taken of max(that leaf's largest |entry| in fp64, DEPTH_GRAD_FLOOR x the
# largest |entry| of the whole fp64 gradient): with every ReLU active, a BN
# bias that feeds the next train-mode BN through a conv has a true gradient
# of about 0 (the batch mean takes the shift out, all but the zero-padded
# border), so its own largest entry is no scale for rounding (one such
# leaf, at 1.1e-5 of the gradient's largest entry, moved by 1.35e-3 of its
# own). The card's step is held against fp64 within DEPTH_GRAD_TOL (at most
# 1.55e-4 read); the two pairs with the CPU within DEPTH_CPU_GRAD_TOL, since
# the CPU's own fp32 step lies 1.36e-3 from fp64 on guide_feat_s2's BN bias
# (under 1e-4 on the card; every other leaf of those pairs within 3.0e-4), on an
# H100 80GB HBM3 at 700 W. The same step on the card with TF32 on and in
# bf16 are controls that must exceed DEPTH_GRAD_TOL against fp64 (they read
# 8.5e-3 and 2.0e-2), and the TF32 step DEPTH_CPU_GRAD_TOL against the CPU:
# a limit that passed them could not tell a step in lower precision from a
# true fp32 one.
DEPTH_LOSS_TOL = 1e-5      # relative
DEPTH_GRAD_TOL = 3e-4      # of max(the leaf's largest |entry|, DEPTH_GRAD_FLOOR x the gradient's)
DEPTH_CPU_GRAD_TOL = 2e-3  # the same, for card vs CPU and CPU vs fp64
DEPTH_GRAD_FLOOR = 1e-3
DEPTH_BN_TOL = 1e-5        # of 1 + |x|
DEPTH_PROFILE_STEPS = 3
DEPTH_E2E_FRAMES = 6       # tools.depth_e2e --frames: 6 + 2 frames, make_scene seeds 0-7 (phase 8's)


def depth_train_run(tag, extra, work, device, card):
    """One tools.train_depth run on the card: --synthetic DEPTH_TRAIN_FRAMES
    at 352 x 1216, widths 32-256, bf16, 1 epoch. Every kernel count is set to
    0 just before and read just after. Fatal on a non-finite loss or metric,
    any kernel launch, or a tensor left unchanged (a frozen backbone's
    parameters must stay unchanged and its BN statistics must change).
    Returns (summary, the trained model, the CLI's result)."""
    import torch

    from dfu3d_tpu_torch.tools import train_depth

    name = extra[1]
    frozen = "--freeze_backbone" in extra
    initial = {k: v.detach().clone() for k, v in train_depth.build_model(
        name, train_depth.DEFAULT_WIDTHS, 0, device).state_dict().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    res = train_depth.train(["--synthetic", str(DEPTH_TRAIN_FRAMES), "--epochs", "1",
                             "--val_frac", "0.1", "--out", str(work / tag), "--seed", "0",
                             "--device", device.type, *extra])
    seconds = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    model, steps = res["model"], res["steps"]
    if len(steps) != DEPTH_TRAIN_FRAMES - 1 or not all(
            math.isfinite(v) for st in steps for v in st.values()):
        fail(f"tools.train_depth {tag}: {len(steps)} steps, or a loss or metric not finite: "
             f"{steps}")
    if any(launches.values()):
        fail(f"tools.train_depth {tag} launched a kernel that is not on its path: {launches}")
    params = dict(model.named_parameters())
    frozen_keys = [k for k in params if frozen and k.startswith("backbone.")]
    moved = [k for k in frozen_keys if not torch.equal(params[k], initial[k])]
    unchanged = [k for k, v in model.state_dict().items()
                 if k not in frozen_keys and torch.equal(v, initial[k])]
    if moved or unchanged:
        fail(f"tools.train_depth {tag}: frozen parameters changed {moved[:5]}, tensors left "
             f"unchanged {unchanged[:5]} ({len(moved)}, {len(unchanged)})")
    if not all(torch.isfinite(v).all() for v in model.state_dict().values()):
        fail(f"tools.train_depth {tag}: a parameter or buffer is not finite after training")
    if res["ckpt"] is None or not res["ckpt"].exists():
        fail(f"tools.train_depth {tag} wrote no checkpoint")
    ms = [st["host_ms"] for st in steps]
    median = statistics.median(ms)
    n = len(initial)
    log(f"[depth_train] {tag} ({card}): {len(steps)} bf16 steps at {DEPTH_HW[0]}x{DEPTH_HW[1]}, "
        f"B=1, losses {[round(st['loss'], 3) for st in steps]}; median "
        f"{median:.2f} ms host clock ({1e3 / median:.2f} frames/s; without the first step "
        f"{statistics.median(ms[1:]):.2f} ms); peak memory {peak / 2**30:.3f} GiB; "
        f"{n - len(unchanged) - len(frozen_keys)} of {n} tensors changed"
        + (f", {len(frozen_keys)} frozen backbone parameters unchanged, its BN statistics "
           "changed" if frozen else "")
        + f"; val rmse {res['best_rmse']:.1f} mm; {seconds:.2f} s in all; kernel launches "
        f"{json.dumps(launches)}")
    summary = {"model": name, "freeze_backbone": frozen, "steps": len(steps),
               "losses": [st["loss"] for st in steps], "host_ms": ms,
               "ms_per_step_median": median, "frames_per_s": 1e3 / median,
               "peak_memory_bytes": peak, "tensors": n, "frozen_unchanged": len(frozen_keys),
               "val_rmse_mm": res["best_rmse"], "seconds": seconds, "launches": launches}
    return summary, model, res


def depth_step_card_vs_cpu(device):
    """One fp32 PENetC2 step (DepthTrainStep, refined L2, Adam) at 352 x 1216,
    widths 32-256, from the same weights (the CLI's init, BN biases +3) and
    the same synthetic frame, on the card (TF32 off) and on this machine's
    CPU, and the same step in fp64 on the card as the reference of both:
    losses within DEPTH_LOSS_TOL, every gradient leaf of each pair within
    DEPTH_GRAD_TOL for the card against fp64 and DEPTH_CPU_GRAD_TOL for the
    pairs with the CPU (of the floored scale above), BN statistics within
    DEPTH_BN_TOL. The step with TF32 on and in bf16 must each exceed
    DEPTH_GRAD_TOL against fp64, and the TF32 step DEPTH_CPU_GRAD_TOL
    against the CPU."""
    from unittest import mock

    import numpy as np
    import torch

    from dfu3d_tpu_torch.models.depth_completion import masked_l2_loss
    from dfu3d_tpu_torch.tools import complete_depth, train_depth

    h, w = DEPTH_HW
    rng = np.random.RandomState(1)
    rgb, dense = train_depth.synthetic_frame(rng, h, w)
    keep = rng.rand(h, w) < 0.05
    frame = (rgb, np.where(keep, dense, 0.0).astype(np.float32),
             np.where(~keep, dense, 0.0).astype(np.float32), (w / 2.0, h / 2.0, 720.0, 720.0))

    def step_on(dev, dtype=torch.float32, compute=torch.float32):
        model = train_depth.build_model("penet_c2", train_depth.DEFAULT_WIDTHS, 0, dev)
        with torch.no_grad():
            for k, prm in model.named_parameters():
                if k.endswith("BatchNorm_0.bias"):
                    prm += 3.0
        model.to(dtype)
        step = train_depth.DepthTrainStep(model, True, masked_l2_loss, 1e-3, 1, True, False,
                                          dev, compute)
        t0 = time.perf_counter()
        loss = step(tuple(x.astype(np.float64) if dtype == torch.float64 and
                          isinstance(x, np.ndarray) else x for x in frame))[0].item()
        return (loss, {k: prm.grad.double().cpu() for k, prm in model.named_parameters()},
                {k: b.double().cpu() for k, b in model.named_buffers()},
                time.perf_counter() - t0)

    runs = {"card": step_on(device), "fp64": step_on(device, torch.float64),
            "cpu": step_on(torch.device("cpu"))}
    with mock.patch.object(train_depth, "fp32_math", lambda tf32: complete_depth.fp32_math(True)):
        runs["tf32"] = step_on(device)
    runs["bf16"] = step_on(device, compute=torch.bfloat16)
    ref = runs["fp64"][1]
    scale = {k: g.abs().max().item() for k, g in ref.items()}
    floor = DEPTH_GRAD_FLOOR * max(scale.values())
    out = {"hw": [h, w], "loss": {k: v[0] for k, v in runs.items()},
           "seconds": {k: v[3] for k, v in runs.items()},
           "tol": {"loss": DEPTH_LOSS_TOL, "grad": DEPTH_GRAD_TOL,
                   "grad_with_cpu": DEPTH_CPU_GRAD_TOL, "grad_floor": DEPTH_GRAD_FLOOR,
                   "bn": DEPTH_BN_TOL},
           "fp64_largest_entry": max(scale.values())}
    for a, b in (("card", "cpu"), ("card", "fp64"), ("cpu", "fp64"), ("tf32", "fp64"),
                 ("tf32", "cpu"), ("bf16", "fp64")):
        (la, ga, sa, _), (lb, gb, sb, _) = runs[a], runs[b]
        err = {k: (ga[k] - g).abs().max().item() for k, g in gb.items()}
        rel = {k: e / max(scale[k], floor) for k, e in err.items()}
        own = sorted(((e / scale[k], scale[k] / max(scale.values()), k)
                      for k, e in err.items()), reverse=True)[:5]
        worst = max(rel, key=rel.get)
        beyond = sorted((round(r, 6), k) for k, r in rel.items() if r > 1e-4)
        loss_rel = abs(la - lb) / abs(lb)
        bn_rel = max(((sa[k] - s_).abs() / (1 + s_.abs())).max().item() for k, s_ in sb.items())
        log(f"[depth_train] PENetC2 step at {h}x{w}, {a} vs {b}: loss {la:.6f} vs {lb:.6f} "
            f"({loss_rel:.3g} relative), worst gradient leaf {worst} {rel[worst]:.3g} of its "
            f"floored scale, {len(beyond)} of {len(rel)} leaves beyond 1e-4 {beyond}; of their "
            f"own largest entry (with that of the gradient's largest) at most {own}; BN "
            f"statistics {bn_rel:.3g} of 1 + |x|")
        out[f"{a}_vs_{b}"] = {"loss_rel": loss_rel, "worst_leaf": worst,
                              "grad_rel": rel[worst], "leaves_beyond_1e-4": beyond,
                              "worst_of_own_scale": own, "bn_rel": bn_rel}
        tol = DEPTH_CPU_GRAD_TOL if "cpu" in (a, b) else DEPTH_GRAD_TOL
        if a in ("tf32", "bf16"):
            if rel[worst] <= tol:
                fail(f"the PENetC2 step in {a} passed the fp32 gradient limit against {b} "
                     f"({worst} {rel[worst]}, tol {tol})")
        elif not (loss_rel <= DEPTH_LOSS_TOL and rel[worst] <= tol and bn_rel <= DEPTH_BN_TOL):
            fail(f"the fp32 PENetC2 step, {a} vs {b}: loss {loss_rel}, gradient {worst} "
                 f"{rel[worst]} (tol {tol}), BN {bn_rel}")
    log(f"[depth_train] the step took {runs['card'][3]:.2f} s on the card (TF32 off), "
        f"{runs['fp64'][3]:.2f} s in fp64, {runs['cpu'][3]:.2f} s on the CPU, "
        f"{runs['tf32'][3]:.2f} s with TF32 and {runs['bf16'][3]:.2f} s in bf16")
    return out


def cspn_device_ms(device):
    """Device ms of one PENetC2 step's propagations alone, forward and
    backward, fp32 as in the step: 3 guides (k = 3, 5, 7) x 6 iterations at
    176 x 608 with dilation 2 and at 352 x 1216 with dilation 1, random
    normalised guides and 5 % sparse pins, CUDA events."""
    import torch

    from dfu3d_tpu_torch.models.depth_completion import CSPN_KERNELS, cspn_iterate

    gen = torch.Generator(device=device).manual_seed(0)
    scales = []
    for (h, w), dilation in (((DEPTH_HW[0] // 2, DEPTH_HW[1] // 2), 2), (DEPTH_HW, 1)):
        depth = (torch.rand(1, 1, h, w, device=device, generator=gen) * 30).requires_grad_(True)
        sparse = torch.where(torch.rand(1, 1, h, w, device=device, generator=gen) < 0.05,
                             depth.detach(), 0.0)
        valid = (sparse > 1e-3).float()
        guides = []
        for k in CSPN_KERNELS:
            g = torch.randn(1, k * k, h, w, device=device, generator=gen)
            guides.append((g / g.abs().sum(1, keepdim=True)).requires_grad_(True))
        scales.append((depth, sparse, valid, guides, dilation))

    def run():
        total = 0
        for depth, sparse, valid, guides, dilation in scales:
            for k, g in zip(CSPN_KERNELS, guides):
                total = total + cspn_iterate(depth, g, sparse, valid, k, dilation, 6).sum()
        total.backward()

    return time_ms(run, reps=10, warmup=2)


def depth_pipeline_from_trained(ckpt, work, device):
    """Pipeline 2 from the trained ENet: tools.depth_e2e over phase 8's frames
    (6 + 2 make_scene frames) with the checkpoint in place of its own
    training run, so that tools.complete_depth --ckpt completes every frame
    (bf16) and the factory runs under the gt, sparse and completed depth.
    Fatal unless each source gives a quality line, the completed maps are
    finite, dense and (352, 1216), the factory writes one label file per
    frame, and no kernel launches."""
    import shutil

    import numpy as np

    from dfu3d_tpu_torch.tools import depth_e2e

    wd = work / "depth_e2e"
    (wd / "depth_run").mkdir(parents=True)
    shutil.copy(ckpt, wd / "depth_run" / "best_ckpt.pth")
    reset_launches()
    t0 = time.perf_counter()
    results = depth_e2e.main(["--frames", str(DEPTH_E2E_FRAMES), "--workdir", str(wd),
                              "--device", device.type])
    seconds = time.perf_counter() - t0
    launches = read_launches()
    root = wd / "data"
    ids = sorted(p.stem for p in (root / "velodyne").glob("*.bin"))
    labels = sorted(p.stem for p in (root / "label_train").glob("*.txt"))
    maps = [np.load(root / "depth" / f"{i}.npy") for i in ids]
    if len(ids) != DEPTH_E2E_FRAMES + 2 or labels != ids or set(results) != {
            "gt_depth", "sparse_depth", "completed_depth"}:
        fail(f"tools.depth_e2e: frames {ids}, labels {labels}, sources {list(results)}")
    if not all(m.shape == DEPTH_HW and np.isfinite(m).all() and (m > 0).mean() > 0.5
               for m in maps):
        fail("tools.complete_depth --ckpt of the trained ENet wrote a map that is not finite, "
             "dense and (352, 1216)")
    if any(launches.values()):
        fail(f"pipeline 2 from the trained ENet launched a kernel: {launches}")
    log(f"[depth_train] pipeline 2 from the trained ENet (tools.depth_e2e, {len(ids)} frames, "
        f"{seconds:.2f} s): Car precision / recall by depth source "
        f"{ {k: (v['Car']['precision'], v['Car']['recall']) for k, v in results.items()} }; "
        f"kernel launches {json.dumps(launches)}")
    return {"frames": len(ids), "seconds": seconds, "sources": results, "launches": launches}


def depth_profile(name, model, frames, device):
    """Queue torch.profiler over DEPTH_PROFILE_STEPS bf16 steps of `model`
    (a fresh DepthTrainStep) for the end of the script; returns the dict it
    then fills: busy and idle, the top kernels, and the unfold / fold
    kernels (im2col, col2im: the propagations' patches and their backward)."""
    import torch

    from dfu3d_tpu_torch.models.depth_completion import masked_l2_loss
    from dfu3d_tpu_torch.tools import train_depth

    device_stats = {}

    def profile():
        from dfu3d_tpu_torch import profile_serve

        step = train_depth.DepthTrainStep(model, name != "enet", masked_l2_loss, 1e-3,
                                          len(frames), name != "enet", False, device,
                                          torch.bfloat16)
        step(frames[0])                                   # Adam's state, outside the window

        def run():
            for f in frames[1:1 + DEPTH_PROFILE_STEPS]:
                step(f)
            torch.cuda.synchronize()

        prof = profile_serve.device_profile(run, DEPTH_PROFILE_STEPS)[1]
        top = prof.get("top_kernels", [])
        patches = sum(k["ms_per_step"] for k in top if "im2col" in k["name"]
                      or "col2im" in k["name"])
        device_stats.update({k: v for k, v in prof.items() if k != "top_kernels"},
                            im2col_col2im_ms_per_step=patches, top_kernels=top[:10])
        log(f"[depth_train] {name} device over {DEPTH_PROFILE_STEPS} bf16 steps "
            f"{json.dumps({k: v for k, v in device_stats.items() if k != 'top_kernels'})}")

    DEFERRED_PROFILES.append(profile)
    return device_stats


def depth_train_phase(device, card):
    """Phase 12: depth-completion training on the card through
    tools.train_depth, the fp32 step against the CPU's, the propagations'
    device time, and pipeline 2 from the trained ENet. Returns (summary,
    launches)."""
    runs, launches = {}, {}
    with tempfile.TemporaryDirectory() as work:
        work = Path(work)
        models = {}
        for tag, extra in DEPTH_TRAIN_RUNS:
            runs[tag], model, res = depth_train_run(tag, extra, work, device, card)
            launches[tag] = runs[tag]["launches"]
            if tag in ("enet", "penet_c2"):
                models[tag] = (model, res["frames"][1])
            if tag == "enet":
                enet_ckpt = res["ckpt"]
        check = depth_step_card_vs_cpu(device)
        cspn_ms = cspn_device_ms(device)
        log(f"[depth_train] one PENetC2 step's propagations alone (3 kernels x 6 iterations at "
            f"176x608 d2 and 352x1216 d1, forward + backward, fp32): {cspn_ms:.3f} ms of device "
            f"time ({card})")
        pipeline = depth_pipeline_from_trained(enet_ckpt, work, device)
        launches["pipeline2"] = pipeline["launches"]
    profiles = {tag: depth_profile(tag, m, frames, device) for tag, (m, frames) in models.items()}
    summary = {"card": card, "hw": list(DEPTH_HW), "widths": [32, 64, 128, 256],
               "dtype": "bfloat16", "batch": 1, "runs": runs, "fp32_card_vs_cpu": check,
               "cspn_fwd_bwd_device_ms": cspn_ms, "device": profiles,
               "pipeline2_from_trained": pipeline}
    return summary, launches


NUSC_TRAIN_FRAMES, NUSC_VAL_FRAMES = 16, 8   # phase 13's synthetic nuScenes key frames
NUSC_SWEEPS = 10                             # MAX_SWEEPS of the nuScenes configs
NUSC_REQUESTS = 4                            # SECOND serving, B=4 each
NUSC_PP_REQUESTS = 2                         # PointPillar multi-head serving
NUSC_TRAIN_STEPS = 5
NUSC_LAG_MAX = 0.45                          # s, the ninth sweep's time lag
SECOND_CFG = "cfgs/nuscenes_models/cbgs_second_multihead.yaml"  # from phase 13's work dir
NUSC_VOXEL_CFG = "cfgs/nuscenes_models/cbgs_voxel01_res3d_centerpoint.yaml"
NUSC_CLASSES = ("Car", "Truck", "Construction_vehicle", "Bus", "Trailer", "Barrier",
                "Motorcycle", "Bicycle", "Pedestrian", "Traffic_cone")   # AP_DICT's names


def nuscenes_data(root):
    """Phase 13's data: the synthetic tree, its infos (fatal unless every
    info has 9 sweeps and the gt count is what was written) and one
    __getitem__ in test mode (5 features, time lags 0 .. 0.45 s, capped at
    MAX_POINTS_PER_FRAME by the collate)."""
    import pickle

    import numpy as np

    from dfu3d_tpu_torch.data import nuscenes_synthetic
    from dfu3d_tpu_torch.data.nuscenes_dataset import NuScenesDataset
    from dfu3d_tpu_torch.utils.config import CfgDict, cfg_from_yaml_file

    t0 = time.perf_counter()
    written = nuscenes_synthetic.write_root(root, NUSC_TRAIN_FRAMES, NUSC_VAL_FRAMES)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    infos = nuscenes_synthetic.write_infos(root, written, NUSC_SWEEPS)
    infos_s = time.perf_counter() - t0
    for split, path in infos.items():
        got = pickle.loads(path.read_bytes())
        sweeps = sorted({len(i["sweeps"]) for i in got})
        gt = sum(len(i["gt_boxes"]) for i in got)
        if sweeps != [NUSC_SWEEPS - 1] or gt != written["gt"][split] or \
                len(got) != len(written[split]):
            fail(f"nuScenes infos ({split}): sweeps per info {sweeps}, {gt} gt of "
                 f"{written['gt'][split]} written, {len(got)} infos of {len(written[split])}")
    from dfu3d_tpu_torch.zoo import SECOND_MULTIHEAD_CFG

    cfg = cfg_from_yaml_file(SECOND_MULTIHEAD_CFG, CfgDict())
    cfg.DATA_CONFIG.DATA_PATH = str(root)
    ds = NuScenesDataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, training=False, root_path=root)
    t0 = time.perf_counter()
    item = ds[0]
    get_ms = (time.perf_counter() - t0) * 1e3
    batch, _ = ds.collate_batch([item])
    pts, lags = item["points"], np.unique(item["points"][:, -1])
    kept = int(batch.points_valid.sum())
    if pts.shape[1] != 5 or lags.min() != 0 or not abs(lags.max() - NUSC_LAG_MAX) < 1e-3 or \
            len(lags) != NUSC_SWEEPS or kept != min(len(pts), ds.max_points_per_frame) or \
            len(item["gt_boxes"]) == 0:
        fail(f"nuScenes __getitem__: points {pts.shape}, time lags {lags.tolist()}, "
             f"{kept} kept of {len(pts)} (cap {ds.max_points_per_frame}), "
             f"{len(item['gt_boxes'])} gt")
    summary = {"frames": [NUSC_TRAIN_FRAMES, NUSC_VAL_FRAMES], "sweeps_per_info": NUSC_SWEEPS - 1,
               "gt_written": written["gt"], "write_s": write_s, "infos_s": infos_s,
               "getitem_ms": get_ms, "points_per_frame": len(pts), "points_kept": kept,
               "time_lags_s": [float(lags.min()), float(lags.max())],
               "gt_per_frame": len(item["gt_boxes"])}
    log(f"[nuscenes] synthetic root: {NUSC_TRAIN_FRAMES} train + {NUSC_VAL_FRAMES} val key "
        f"frames with {NUSC_SWEEPS - 1} sweeps each written in {write_s:.2f} s, infos in "
        f"{infos_s:.2f} s (gt {written['gt']}); one test-mode frame {get_ms:.1f} ms: "
        f"{len(pts)} points x 5 features, time lags {lags.min():.2f}-{lags.max():.2f} s, "
        f"{kept} kept by the collate's cap, {len(item['gt_boxes'])} gt")
    return infos, summary


def serve_anchor(name, model, batches, device, b1_per_batch, b2_per_batch):
    """A warm-up request, the counts set to 0, the requests through
    eval_batches (bf16), the counts read; fatal unless each batch launched
    B1 and the tensor-core B2 exactly as its step implies and no CUDA-core
    B2. Returns (EvalResult, launches)."""
    import torch

    from dfu3d_tpu_torch.train.eval_utils import eval_batches

    eval_batches(model, batches[:1], RECALL_THRESH, device=device, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    reset_launches()
    res = eval_batches(model, batches, RECALL_THRESH, device=device, dtype=torch.bfloat16)
    launches = read_launches()
    n = len(batches)
    post_max = int(model.model_cfg.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE)
    for k, (boxes, scores, labels, valid) in enumerate(res.preds):
        if boxes.shape != (4, post_max, 7) or not torch.isfinite(boxes).all() or \
                not torch.isfinite(scores).all() or not valid.any(dim=1).all():
            fail(f"{name} batch {k}: boxes {tuple(boxes.shape)}, finite "
                 f"{bool(torch.isfinite(boxes).all())}, kept per sample {valid.sum(1).tolist()}")
    if launches["iou_bev_overlap"] != b1_per_batch * n or \
            launches["gather_gemm_tensor_core"] != b2_per_batch * n or \
            launches["gather_gemm_cuda_core"]:
        fail(f"{name} serving: kernel launches {launches} for {n} batches, not "
             f"{b1_per_batch} B1 and {b2_per_batch} tensor-core B2 per batch")
    log(f"[nuscenes] {name} serving, {n} requests of B=4 (bf16): per-request ms median "
        f"{statistics.median(res.batch_seconds) * 1e3:.2f} (all: "
        f"{', '.join(f'{s * 1e3:.2f}' for s in res.batch_seconds)}); kept per sample "
        f"{[p[3].sum(1).tolist() for p in res.preds]}; recall {json.dumps(res.metric)}; "
        f"kernel launches {json.dumps(launches)}")
    return res, launches


def count_positive_anchors():
    """A hook on the anchor detectors' target assignment that records each
    call's positive anchors; returns (the list they go to, undo)."""
    from dfu3d_tpu_torch.models import pointpillar

    seen, orig = [], pointpillar.AnchorDetectorBase.assign_targets

    def counting(self, *a, **k):
        out = orig(self, *a, **k)
        seen.append(int((out.box_cls_labels > 0).sum()))
        return out

    pointpillar.AnchorDetectorBase.assign_targets = counting
    return seen, lambda: setattr(pointpillar.AnchorDetectorBase, "assign_targets", orig)


def nuscenes_cli(root, cfg_file, b2_train, b2_eval, device):
    """tools.train (1 epoch, bf16) and tools.test of its checkpoint on a
    nuScenes config from `root`, gt sampling disabled (no nuScenes gt
    database exists); fatal unless every train step launched the
    tensor-core B2 `b2_train` times and no B1, the eval launched B2
    `b2_eval` and B1 twice per batch, results came back for every val frame
    and the AP_DICT holds the ten classes. Returns the summary and the
    launches of training and evaluation."""
    from dfu3d_tpu_torch.tools import test as test_cli, train as train_cli

    sets = ["--set", "DATA_CONFIG.DATA_PATH", str(root),
            "DATA_CONFIG.DATA_AUGMENTOR.DISABLE_AUG_LIST", "gt_sampling"]
    common = ["--cfg_file", cfg_file, "--device", device.type, "--workers", str(LOADER_WORKERS)]
    tag = Path(cfg_file).stem
    reset_launches()
    t0 = time.perf_counter()
    out = train_cli.main(common + ["--epochs", "1"] + sets)
    train_s = time.perf_counter() - t0
    train_launches = read_launches()
    steps = out["epochs"][0]["steps"]
    if train_launches["gather_gemm_tensor_core"] != b2_train * steps or \
            train_launches["gather_gemm_cuda_core"] or train_launches["iou_bev_overlap"] or \
            not math.isfinite(out["epochs"][0]["loss"]):
        fail(f"tools.train {tag}: {steps} steps, loss {out['epochs'][0]['loss']}, kernel "
             f"launches {train_launches} (want {b2_train} tensor-core B2 per step, no B1)")
    ckpt = sorted(Path(out["ckpt_dir"]).glob("checkpoint_epoch_*.pth"))
    if not ckpt:
        fail(f"tools.train {tag} wrote no checkpoint")
    reset_launches()
    t0 = time.perf_counter()
    (_, _, result), = test_cli.main(common + ["--ckpt", str(ckpt[-1])] + sets)
    eval_s = time.perf_counter() - t0
    eval_launches = read_launches()
    batches = result["eval_batches"]
    classes = {k.split("/")[0].rsplit("_", 1)[0] for k in result if "_3d/" in k}
    if result["num_frames"] != NUSC_VAL_FRAMES or classes != set(NUSC_CLASSES) or \
            eval_launches["gather_gemm_tensor_core"] != b2_eval * batches or \
            eval_launches["iou_bev_overlap"] != 2 * batches:
        fail(f"tools.test {tag}: {result['num_frames']} frames of {NUSC_VAL_FRAMES}, classes "
             f"{sorted(classes)}, {batches} batches, kernel launches {eval_launches}")
    summary = {"train_steps": steps, "train_s": train_s, "train_loss": out["epochs"][0]["loss"],
               "train_launches": train_launches, "eval_s": eval_s, "eval_batches": batches,
               "eval_launches": eval_launches, "eval_frames": result["num_frames"],
               "gt_num": result["gt_num"],
               "car_3d_moderate_R40": result["Car_3d/moderate_R40"],
               "time_split_s": {k: result[k] for k in result if k.startswith("time/")}}
    log(f"[nuscenes] {tag} from disk: tools.train {steps} steps (class-balanced resampling of "
        f"{NUSC_TRAIN_FRAMES} frames) in {train_s:.2f} s, loss {out['epochs'][0]['loss']:.4f}, "
        f"launches {json.dumps(train_launches)}; tools.test {result['num_frames']} frames in "
        f"{eval_s:.2f} s, AP_DICT with {len(classes)} classes, launches "
        f"{json.dumps(eval_launches)}")
    return summary, train_launches, eval_launches


def nuscenes_profiles(summary):
    """profile_serve --model second and profile_train --model second, each in
    a process of its own, run with the deferred profiles after every
    host-clock reading; their spans and device profiles go into
    `summary`."""
    for tool, flag, key in (("profile_serve", "--batches", "profile_serve"),
                            ("profile_train", "--steps", "profile_train")):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as work:
            out = Path(work) / f"{key}.json"
            run = subprocess.run([sys.executable, "-m", f"dfu3d_tpu_torch.{tool}", "--model",
                                  "second", flag, "4", "--out", str(out)], cwd=REPO,
                                 capture_output=True, text=True)
            if run.returncode != 0 or not out.exists():
                fail(f"{tool} --model second failed: {run.stderr[-3000:]}")
            prof = json.loads(out.read_text())
        keep = {k: prof[k] for k in ("step_ms", "samples_per_s", "phase_ms", "nms_scan")
                if k in prof}
        keep["profile"] = {k: v for k, v in prof["profile"].items() if k != "top_kernels"}
        keep["profile"]["top_kernels"] = prof["profile"].get("top_kernels", [])[:8]
        summary[key] = keep
        p = keep["profile"]
        log(f"[nuscenes] {tool} --model second ({time.perf_counter() - t0:.1f} s): step "
            f"{prof['step_ms']['median']:.2f} ms host clock; busy "
            f"{p.get('device_busy_ms_per_step', float('nan')):.2f} ms, idle "
            f"{p.get('device_idle_share', float('nan')):.3f}; spans (ms) "
            + ", ".join(f"{k} {v:.2f}" for k, v in sorted(prof["phase_ms"].items(),
                                                           key=lambda kv: -kv[1])[:10]))


def nuscenes_phase(device, card):
    """Phase 13: nuScenes from disk and the anchor detectors. Returns (the
    summary, launches by path, the B1 entries timed, B2 totals and entries
    of one served SECOND request and of one train step's dX)."""
    import os

    import torch

    from dfu3d_tpu_torch import zoo
    from dfu3d_tpu_torch.core.geometry import iou_kernel
    from dfu3d_tpu_torch.core.voxel import gather_gemm_kernel
    from dfu3d_tpu_torch.flagship import seeded_weights_
    from dfu3d_tpu_torch.train.train_state import make_eval_step

    swaps = [(iou_kernel, "overlap_bev", "overlap_bev_plain"),
             (gather_gemm_kernel, "gather_gemm", "gather_gemm_plain")]
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as work:
        work = Path(work)
        (work / "cfgs").symlink_to(REPO / "tools" / "cfgs")
        os.chdir(work)
        try:
            root = work / "data" / "nuscenes"
            infos, summary = nuscenes_data(root)
            launches = {}

            # SECOND serving
            cfg, grid, model = zoo.second_multihead(device=device)
            seeded_weights_(model, seed=0)
            batches = zoo.nuscenes_batches(cfg, root, infos["train"], NUSC_REQUESTS)
            log(f"[nuscenes] SECOND multi-head {'x'.join(map(str, grid.grid_size))} grid, "
                f"max_voxels {model.vfe.max_voxels}, {model.anchors_flat.shape[0]} anchors per "
                f"frame, {sum(p.numel() for p in model.parameters())} parameters; points per "
                f"request {[b.points_valid.sum(1).tolist() for b in batches]}")
            res, launches["second"] = serve_anchor("second", model, batches, device, 2, 12)
            served_iou = time_served_overlaps("second", model, batches[0], device)
            calls = record_gemm_calls(
                lambda: make_eval_step(model, device=device, dtype=torch.bfloat16)(batches[0]))
            if len(calls) != len(VOXEL8X_CONVS):
                fail(f"one SECOND eval step made {len(calls)} gather-GEMM calls, not 12")
            served_b2 = hold_gemm_calls("SECOND, one served request", zip(VOXEL8X_CONVS, calls))
            check = check_paths("second", model, cfg, batches[0], res.preds[0], swaps, device)
            summary["second_serve"] = {
                "request_ms": [s * 1e3 for s in res.batch_seconds],
                "request_ms_median": statistics.median(res.batch_seconds) * 1e3,
                "recall": res.metric, "launches": launches["second"], "fp32_check": check}
            del model, res

            # PointPillar multi-head serving
            pcfg, pgrid, pp = zoo.pp_multihead(device=device)
            seeded_weights_(pp, seed=0)
            pbatches = zoo.nuscenes_batches(pcfg, root, infos["train"], NUSC_PP_REQUESTS)
            res, launches["pp"] = serve_anchor("pp", pp, pbatches, device, 2, 0)
            pillars = [pillar_counts(b, pgrid, pp.vfe.max_pillars) for b in pbatches]
            for k, (distinct, kept) in enumerate(pillars):
                log(f"[nuscenes] pp batch {k}: pillars per sample {distinct}, kept {kept} (cap "
                    f"{4 * pp.vfe.max_pillars} per batch), dropped "
                    f"{[d - p for d, p in zip(distinct, kept)]}")
            summary["pp_serve"] = {
                "request_ms": [s * 1e3 for s in res.batch_seconds],
                "launches": launches["pp"],
                "pillars": [{"per_sample": d, "kept": p} for d, p in pillars]}
            del pp, res

            # SECOND training
            tbatches = zoo.nuscenes_batches(cfg, root, infos["train"], NUSC_TRAIN_STEPS,
                                            training=True)
            positives, undo = count_positive_anchors()
            try:
                model, launches["second_train"], steps, _ = train(
                    "second", zoo.second_multihead, tbatches, device)
            finally:
                undo()
            bad = [s for s in steps if s["gather_gemm_tensor_core"] != VOXEL8X_TRAIN_B2
                   or s["gather_gemm_cuda_core"] or s["iou_bev_overlap"]]
            if bad or len(positives) != len(steps) or min(positives) == 0:
                fail(f"a SECOND train step launched other than {VOXEL8X_TRAIN_B2} tensor-core "
                     f"B2 and no B1 ({bad}), or had no positive anchor ({positives})")
            log(f"[nuscenes] SECOND train steps: positive anchors {positives}")

            def step():
                model.train()
                model.zero_grad(set_to_none=True)
                with torch.autocast("cuda", dtype=torch.bfloat16):
                    loss, _ = model(tbatches[0].to(device))
                loss.backward()
                model.zero_grad(set_to_none=True)

            calls = record_gemm_calls(step)
            if len(calls) != VOXEL8X_TRAIN_B2:
                fail(f"one SECOND train step made {len(calls)} gather-GEMM calls, not "
                     f"{VOXEL8X_TRAIN_B2}")
            train_dx = hold_gemm_calls("dX of one SECOND train step",
                                       zip(VOXEL8X_CONVS[::-1], calls[len(VOXEL8X_CONVS):]))
            train_check = check_train_paths("second", model, tbatches[0], swaps, device)
            ms = [s["host_ms"] for s in steps]
            summary["second_train"] = {
                "steps": steps, "positive_anchors": positives,
                "step_ms_median": statistics.median(ms),
                "samples_per_s": 4 / (statistics.median(ms) / 1e3),
                "launches": launches["second_train"], "fp32_check": train_check}
            del model

            # from disk through the CLIs
            summary["cli_second"], launches["second_cli_train"], launches["second_cli_eval"] = \
                nuscenes_cli(root, SECOND_CFG, VOXEL8X_TRAIN_B2, 12, device)
            summary["cli_voxel"], launches["voxel_cli_train"], launches["voxel_cli_eval"] = \
                nuscenes_cli(root, NUSC_VOXEL_CFG, VOXEL_TRAIN_B2, 21, device)

            # where the time goes: with the deferred profiles, last
            DEFERRED_PROFILES.append(lambda: nuscenes_profiles(summary))
        finally:
            os.chdir(cwd)
    summary["device"] = card
    return summary, launches, served_iou, served_b2, train_dx


# per model: served requests of B=4, bf16 train steps; the three models of
# the previous slice run shorter to keep the whole script within 750 s
TWO_STAGE_DEPTH = {"second_iou": (2, 3), "voxel_rcnn": (2, 3), "pv_rcnn": (2, 3),
                   "parta2": (4, 5), "pv_rcnn_plusplus": (4, 5)}
TWO_STAGE_FRAMES = (16, 8)                 # phase 14's synthetic KITTI root: train, val
TWO_STAGE_CLASSES = ("Car", "Pedestrian", "Cyclist")
TWO_STAGE_B1_PER_BATCH = 3                 # proposal NMS, final NMS, recall
TWO_STAGE_B1_PER_STEP = 2                  # proposal NMS, the RoI targets' 3D IoU
ENCODER_CONVS = ["conv_in", "conv1", "down2", "down2_refine", "down3", "down3_refine", "down4",
                 "down4_refine", "conv_out"]   # SparseEncoder, forward order
UNET_CONVS = ENCODER_CONVS + ["up3", "up2", "up1"]   # SparseUNet (PartA2), forward order
TWO_STAGE_CONVS = {"second_iou": VOXEL8X_CONVS, "voxel_rcnn": ENCODER_CONVS,
                   "pv_rcnn": ENCODER_CONVS, "parta2": UNET_CONVS,
                   "pv_rcnn_plusplus": ENCODER_CONVS}   # phase 14's models, in the order it runs them
TWO_STAGE_CLI = ("voxel_rcnn", "parta2")   # the models phase 14 also runs from disk
# the RoI head's regression branch, which the fp32 train check requires a
# gradient on (SECOND-IoU has only its IoU branch)
TWO_STAGE_REG = {"second_iou": ("iou_fc.",), "voxel_rcnn": ("reg_fc.", "reg_pred."),
                 "pv_rcnn": ("reg_fc.",), "parta2": ("roi_head.reg_fc.",),
                 "pv_rcnn_plusplus": ("reg_fc.",)}
# the 99th percentile of a train step's proposals' largest |corner
# coordinate| may reach this many times the point-cloud range's largest
# |coordinate|: it stays within 0.7-1.03 times it over 5 steps, while a
# single box of a step's 9000 may reach 130 times it (exp of its size
# codes) and a later step's largest fall back to 1.1 times; a loop that
# fed the RPN its own proposals as gt sent them 7e6 times it away in 5 steps
TWO_STAGE_EXTENT_FACTOR = 10


def two_stage_cfg_file(name):
    """A phase 14 model's config, as its work dir (cfgs/ -> tools/cfgs/)
    names it."""
    from dfu3d_tpu_torch.zoo import TWO_STAGE_CFGS

    return f"cfgs/kitti_models/{TWO_STAGE_CFGS[name]}"


def compact_gemm(entries):
    """[conv, shape, ms, plain_ms, library_ms, bound_ms] of hold_gemm_calls'
    entries."""
    return [[e["conv"], e["shape"], *(round(e[k], 5) for k in ("ms", "plain_ms", "library_ms",
                                                                 "bound_ms"))]
            for e in entries]


def two_stage_root(work):
    """Phase 14's data: a synthetic KITTI root (kitti_synthetic at its
    defaults: 40,000-60,000 points in the camera frustum, 20-40 boxes of
    Car, Pedestrian and Cyclist) of TWO_STAGE_FRAMES, its infos and the
    train split's gt database under the name the KITTI configs' gt sampling
    reads (tools.create_infos)."""
    from dfu3d_tpu_torch.data import kitti_synthetic
    from dfu3d_tpu_torch.tools import create_infos

    root = work / "data" / "kitti"
    kitti_synthetic.write_root(root, *TWO_STAGE_FRAMES, list(TWO_STAGE_CLASSES), seed=14)
    # the three-class config: its gt database holds every class
    out = create_infos.main(["--cfg_file", two_stage_cfg_file("second_iou"), "--data_path",
                             str(root)])
    infos = {Path(p).stem.rsplit("_", 1)[-1]: Path(p) for p in out["infos"]}
    if Path(out["dbinfos"]).name != "kitti_dbinfos_train.pkl" or set(infos) != {"train", "val"}:
        fail(f"tools.create_infos on phase 14's root wrote {out}")
    return root, infos


def two_stage_serve(name, model, batches, device):
    """A warm-up request, the peak memory and every kernel count set to 0,
    the requests through eval_batches (bf16), the counts and the peak read.
    Fatal unless every request launched B1 TWO_STAGE_B1_PER_BATCH times and
    the tensor-core B2 once per sparse conv, and no CUDA-core B2, or on a
    non-finite, misshapen or empty output. Returns (EvalResult, launches,
    summary)."""
    import torch

    from dfu3d_tpu_torch.train.eval_utils import eval_batches

    eval_batches(model, batches[:1], RECALL_THRESH, device=device, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res = eval_batches(model, batches, RECALL_THRESH, device=device, dtype=torch.bfloat16)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    n, convs = len(batches), len(TWO_STAGE_CONVS[name])
    post_max = int(model.model_cfg.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE)
    for k, (boxes, scores, labels, valid) in enumerate(res.preds):
        if boxes.shape[:2] != (4, min(post_max, model.proposal_nms["post_max"])) or \
                not torch.isfinite(boxes).all() or not torch.isfinite(scores).all() or \
                not valid.any(dim=1).all():
            fail(f"{name} request {k}: boxes {tuple(boxes.shape)}, finite "
                 f"{bool(torch.isfinite(boxes).all())}, kept per frame {valid.sum(1).tolist()}")
    if launches["iou_bev_overlap"] != TWO_STAGE_B1_PER_BATCH * n or \
            launches["gather_gemm_tensor_core"] != convs * n or launches["gather_gemm_cuda_core"]:
        fail(f"{name} serving: kernel launches {launches} for {n} requests, not "
             f"{TWO_STAGE_B1_PER_BATCH} B1 and {convs} tensor-core B2 per request")
    ms = [s * 1e3 for s in res.batch_seconds]
    summary = {"request_ms": {"median": statistics.median(ms), "all": ms},
               "kept_per_frame": [p[3].sum(1).tolist() for p in res.preds],
               "recall": res.metric, "launches": launches,
               "launches_per_request": {k: v / n for k, v in launches.items()},
               "peak_memory_gib": peak / 2 ** 30}
    log(f"[two_stage] {name} serving, {n} requests of B=4 (bf16): ms per request median "
        f"{summary['request_ms']['median']:.2f} (all: {', '.join(f'{v:.2f}' for v in ms)}); "
        f"peak memory {summary['peak_memory_gib']:.2f} GiB; kept per frame "
        f"{summary['kept_per_frame']}; launches per request "
        f"{json.dumps(summary['launches_per_request'])}")
    return res, launches, summary


def two_stage_profile(tag, model, run, batches, optimizer=None):
    """profile_serve.two_stage_profile over the batches (the spans' medians,
    PV-RCNN's FPS share, the keep-scan's iterations) and the card's busy
    and idle share over one step (torch.profiler, deferred to the end)."""
    from dfu3d_tpu_torch import profile_serve

    out = profile_serve.two_stage_profile(model, run, batches, optimizer)
    out["device_time"] = defer_device_profile(tag, lambda: run(batches[0]))
    ph = out["phase_ms"]
    log(f"[two_stage] {tag} instrumented step {ph['step']:.2f} ms; spans (ms) "
        + ", ".join(f"{k} {v:.2f}" for k, v in sorted(ph.items(), key=lambda kv: -kv[1])[1:12])
        + (f"; FPS share {out['fps_share']:.1%}" if "fps_share" in out else "")
        + f"; keep-scan iterations {[c['iterations'] for c in out['keep_scan']]}")
    return out


def check_two_stage_train_paths(name, model, batch, device):
    """One fp32 train step of the two-stage model through the kernels
    against the same through their plain twins, the batch with
    `zoo.proposal_gt`'s gt and the RoI sampler's uniforms from a generator
    seeded 0 in every run. B1 alone first: the train forward through B1 and
    through its twin (B2 through the kernel in both; B1 has no backward and
    enters only the NMS keep decisions and the targets' IoUs) must sample
    the same RoIs, with RoIs over REG_FG_THRESH, and give the loss within
    TRAIN_LOSS_TOL relative. Then B2 (`check_train_paths`): the loss of the
    forward through B2's twin within TRAIN_LOSS_TOL relative, each gradient
    with B2's dX through the kernel or the twin within TRAIN_GRAD_TOL of its
    largest entry (or 4x the twin's reordering spread), and no leaf all
    zero, the RoI head's regression branch among them. The twin's fp32 sums
    reorder near-tied RPN scores, and the RoIs sampled from those differ:
    B2's runs go on with the RoIs of the first (kernel) run, and how many
    of them sampled the same on their own is reported."""
    import torch

    from dfu3d_tpu_torch.core.geometry import iou_kernel
    from dfu3d_tpu_torch.core.voxel import gather_gemm_kernel
    from dfu3d_tpu_torch.models import roi_head
    from dfu3d_tpu_torch.zoo import proposal_gt

    batch = proposal_gt(model, batch.to(device))
    weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    sampled, fg, targets_fn = [], [], roi_head.assign_roi_targets

    def recording(*a, **k):
        out = targets_fn(*a, **k)
        sampled.append(out["sampled_idx"].clone())
        fg.append(int(out["reg_valid_mask"].sum()))
        return out

    def forward(plain_b1):
        with plain_twins([(iou_kernel, "overlap_bev", "overlap_bev_plain")] if plain_b1 else []):
            model.load_state_dict(weights)
            model.train()
            with torch.no_grad():
                loss, _ = model(batch)
        return loss.item()

    replay = []

    def replaying(*a, **k):
        # B2's runs: each samples its own RoIs (kept for the report) and
        # goes on with the first run's, so that the loss and the gradients
        # compare the same RoIs
        out = targets_fn(*a, **k)
        sampled.append(out["sampled_idx"].clone())
        replay.append(replay[0] if replay else out)
        return replay[0]

    roi_head.assign_roi_targets = recording
    try:
        k_loss, p_loss = forward(False), forward(True)
        b1_sampled, b1_fg = sampled[:2], fg[:2]
        sampled.clear()
        roi_head.assign_roi_targets = replaying
        check = check_train_paths(
            name, model, batch, [(gather_gemm_kernel, "gather_gemm", "gather_gemm_plain")],
            device, scales=True)
    finally:
        roi_head.assign_roi_targets = targets_fn
    model.load_state_dict(weights)
    model.zero_grad(set_to_none=True)
    b1_rel = abs(k_loss - p_loss) / abs(p_loss)
    if not b1_sampled[0].equal(b1_sampled[1]) or not min(b1_fg) > 0 or \
            not b1_rel <= TRAIN_LOSS_TOL:
        fail(f"{name} fp32 train forward, B1 vs its twin: sampled RoIs equal "
             f"{b1_sampled[0].equal(b1_sampled[1])}, over REG_FG_THRESH {b1_fg}, loss "
             f"{b1_rel:.3g} relative")
    reg = {k: v for k, v in check.pop("leaf_scales").items()
           if k.startswith(TWO_STAGE_REG[name])}
    b2_equal = sum(s.equal(sampled[0]) for s in sampled)
    check.update(b1_loss_rel_err=b1_rel, b1_sampled_rois_equal=True, fg_rois=b1_fg[0],
                 b2_runs_sampling_as_the_kernels=f"{b2_equal} of {len(sampled)}",
                 reg_branch_grad_max=reg)
    log(f"[two_stage] {name} fp32 train step: B1 vs its twin samples the same "
        f"{b1_sampled[0].numel()} RoIs ({b1_fg[0]} over REG_FG_THRESH), loss {b1_rel:.2e} "
        f"relative; B2's runs sampling as the kernel run: {b2_equal} of {len(sampled)}; the "
        f"regression branch's leaves all nonzero, largest entries "
        f"{json.dumps({k: float(f'{v:.3g}') for k, v in reg.items()})}")
    return check


def two_stage_cli(name, root, device):
    """A phase 14 model (TWO_STAGE_CLI: Voxel R-CNN, PartA2) from disk:
    tools.train for 1 epoch (TWO_STAGE_FRAMES[0] frames, B=4, gt sampling
    and the world augmentations, bf16) and tools.test --ckpt of its
    checkpoint on the val split; fatal on a non-finite loss, no checkpoint,
    a train step that does not launch B1 twice and the tensor-core B2 once
    per sparse conv and once per dX (17 for Voxel R-CNN, 23 for PartA2), an
    eval batch that does not launch B1 3 times and B2 once per sparse conv,
    a missing KITTI txt or no Car in the AP_DICT."""
    from dfu3d_tpu_torch.tools import test as test_cli, train as train_cli

    cfg_file = two_stage_cfg_file(name)
    common = ["--cfg_file", cfg_file, "--workers", str(LOADER_WORKERS), "--extra_tag",
              "chip_smoke"]
    data_path = ["--set", "DATA_CONFIG.DATA_PATH", str(root)]
    convs = TWO_STAGE_CONVS[name]
    b2_step = 2 * len(convs) - 1
    reset_launches()
    t0 = time.perf_counter()
    trained = train_cli.main([*common, "--epochs", "1", *data_path])
    train_s = time.perf_counter() - t0
    train_launches = read_launches()
    (epoch,) = trained["epochs"]
    ckpt = trained["ckpt_dir"] / "checkpoint_epoch_1.pth"
    if not epoch["steps"] or not all(math.isfinite(v) for v in epoch["losses"]) or \
            not ckpt.exists():
        fail(f"tools.train {cfg_file}: {epoch}, checkpoint {ckpt.exists()}")
    if train_launches["iou_bev_overlap"] != TWO_STAGE_B1_PER_STEP * epoch["steps"] or \
            train_launches["gather_gemm_tensor_core"] != b2_step * epoch["steps"] or \
            train_launches["gather_gemm_cuda_core"]:
        fail(f"tools.train {cfg_file}: kernel launches {train_launches}, not B1 "
             f"{TWO_STAGE_B1_PER_STEP} and tensor-core B2 {b2_step} per step ({epoch['steps']})")
    reset_launches()
    t0 = time.perf_counter()
    ((_, result_dir, res),) = test_cli.main([*common, "--ckpt", str(ckpt), "--save_to_file",
                                             *data_path])
    test_s = time.perf_counter() - t0
    eval_launches = read_launches()
    txts = len(list((result_dir / "final_result" / "data").glob("*.txt")))
    batches = res["eval_batches"]
    if txts != TWO_STAGE_FRAMES[1] or "Car_3d/moderate_R40" not in res or \
            eval_launches["iou_bev_overlap"] != TWO_STAGE_B1_PER_BATCH * batches or \
            eval_launches["gather_gemm_tensor_core"] != len(convs) * batches:
        fail(f"tools.test {cfg_file}: {txts} txts for {TWO_STAGE_FRAMES[1]} val frames, AP keys "
             f"{[k for k in res if '_3d/' in k][:3]}, kernel launches {eval_launches} for "
             f"{batches} batches")
    log(f"[two_stage] {name} from disk: tools.train {epoch['steps']} steps, losses "
        f"{[round(v, 4) for v in epoch['losses']]}, "
        f"{epoch['batch_time'] / epoch['steps'] * 1e3:.1f} ms per step host clock, "
        f"{train_s:.2f} s in all, launches {json.dumps(train_launches)}; tools.test "
        f"{res['num_frames']} frames in {batches} batches, {txts} KITTI txts, "
        f"{test_s:.2f} s, Car 3D moderate R40 {res['Car_3d/moderate_R40']:.2f}, launches "
        f"{json.dumps(eval_launches)}")
    return ({"config": cfg_file.replace("cfgs/", "tools/cfgs/", 1),
             "train": {**epoch, "ms_per_step": epoch["batch_time"] / epoch["steps"] * 1e3,
                       "seconds": train_s, "launches": train_launches},
             "eval": {"sec_per_example": res["sec_per_example"], "eval_batches": batches,
                      "num_frames": res["num_frames"], "txts": txts, "seconds": test_s,
                      "launches": eval_launches,
                      "car_3d_moderate_R40": res["Car_3d/moderate_R40"]}},
            train_launches, eval_launches)


def two_stage_model(name, root, infos, device, card):
    """Phase 14 for one model: serving (launches, ms, peak memory, spans,
    the served B1 and B2 calls held and timed, the fp32 request through the
    kernels and through the twins), then at the seeded weights the train
    batches' gt (made once from the seeded model's proposals), the train
    forward's B1 calls held, the dX calls checked, held and timed and the
    fp32 step through the kernels and through the twins, then training
    (TWO_STAGE_DEPTH's bf16 steps through train_model on those batches, each
    step's proposal extent, spans). Returns (summary, launches by path, served B1 entries,
    train B1 entries, (served B2 totals, entries), (dX totals, entries))."""
    import torch

    from dfu3d_tpu_torch import zoo
    from dfu3d_tpu_torch.core.geometry import iou_kernel
    from dfu3d_tpu_torch.core.voxel import gather_gemm_kernel
    from dfu3d_tpu_torch.flagship import seeded_weights_
    from dfu3d_tpu_torch.profile_serve import _run
    from dfu3d_tpu_torch.train.train_state import make_eval_step, make_train_step

    build = getattr(zoo, name)
    convs = TWO_STAGE_CONVS[name]
    requests, train_steps = TWO_STAGE_DEPTH[name]
    seconds, launches = {}, {}
    t0 = time.perf_counter()
    cfg, grid, model = build(device=device)
    seeded_weights_(model, seed=0)
    batches = zoo.kitti_batches(cfg, root, infos["val"], requests, 4)
    seconds["setup_serve"] = time.perf_counter() - t0
    log(f"[two_stage] {name}: {cfg.MODEL.NAME} {'x'.join(map(str, grid.grid_size))} grid, "
        f"max_voxels {model.vfe.max_voxels}, {model.anchors_flat.shape[0]} anchors per frame, "
        f"{sum(p.numel() for p in model.parameters())} parameters; points per request "
        f"{[b.points_valid.sum(1).tolist() for b in batches]}")

    t0 = time.perf_counter()
    res, launches[name], serve = two_stage_serve(name, model, batches, device)
    step = make_eval_step(model, RECALL_THRESH, device=device, dtype=torch.bfloat16)
    serve["profile"] = two_stage_profile(name, model, lambda b: _run(step, b), batches)
    served_b1 = time_served_overlaps(name, model, batches[0], device,
                                     ("proposal_nms", "final_nms", "recall"))
    calls = record_gemm_calls(lambda: step(batches[0]))
    if len(calls) != len(convs):
        fail(f"one {name} eval step made {len(calls)} gather-GEMM calls, not {len(convs)}")
    served_b2 = hold_gemm_calls(f"{name}, one served request", zip(convs, calls))
    swaps = [(iou_kernel, "overlap_bev", "overlap_bev_plain"),
             (gather_gemm_kernel, "gather_gemm", "gather_gemm_plain")]
    serve["fp32_check"] = check_paths(name, model, cfg, batches[0], res.preds[0], swaps, device)
    seconds["serve"] = time.perf_counter() - t0
    del res   # the model and its step stay for the deferred device profile

    t0 = time.perf_counter()
    b = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    tbatches = zoo.kitti_batches(cfg, root, infos["train"], train_steps, b,
                                 training=True)
    b2_step = 2 * len(convs) - 1

    # every train batch's gt (zoo.proposal_gt), made once from the seeded
    # model, so that no step trains on its own proposals; its forwards'
    # launches are a path of their own
    _, _, model = build(device=device, train=True)
    seeded_weights_(model, seed=0)
    reset_launches()
    gt_batches = [zoo.proposal_gt(model, bt, torch.bfloat16) for bt in tbatches]
    launches[f"{name}_gt"] = read_launches()
    train_b1 = train_overlaps(name, model, gt_batches[0], device, coord_tol=True)

    # one bf16 step's forward and backward B2 calls, recorded apart
    weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    model.train()
    model.zero_grad(set_to_none=True)
    loss = []

    def bf16_forward():
        with torch.autocast("cuda", dtype=torch.bfloat16):
            loss.append(model(gt_batches[0].to(device))[0])

    fwd = record_gemm_calls(bf16_forward)
    dx = record_gemm_calls(lambda: loss[0].backward())
    model.zero_grad(set_to_none=True)
    model.load_state_dict(weights)
    check_dx_mirrors(convs, fwd, dx)
    b2_split = {"forward": len(fwd), "dx": len(dx)}
    train_dx = hold_gemm_calls(f"dX of one {name} train step", zip(convs[::-1], dx))
    check = check_two_stage_train_paths(name, model, tbatches[0], device)
    del model, loss, fwd, dx

    # each step's proposals, read from the corners of its proposal NMS (the
    # first of its B1 calls)
    reach = max(abs(float(v)) for v in cfg.DATA_CONFIG.POINT_CLOUD_RANGE)
    extents, b1_fn = [], iou_kernel.overlap_bev

    def measuring(ca, cb):
        # per proposal its largest |corner coordinate|: the largest, the
        # 99th percentile, the share beyond the range
        e = ca.detach().abs().amax(dim=(2, 3)).flatten().float()
        extents.append(torch.stack([e.max(), torch.quantile(e, 0.99), (e > reach).float().mean()]))
        return b1_fn(ca, cb)

    torch.cuda.reset_peak_memory_stats()
    iou_kernel.overlap_bev = measuring
    try:
        model, launches[f"{name}_train"], steps, state = train(name, build, gt_batches, device)
    finally:
        iou_kernel.overlap_bev = b1_fn
    peak = torch.cuda.max_memory_allocated()
    bad = [s["it"] for s in steps if s["iou_bev_overlap"] != TWO_STAGE_B1_PER_STEP
           or s["gather_gemm_tensor_core"] != b2_step or s["gather_gemm_cuda_core"]]
    # the first step runs the seeded weights that made the gt, so it has a
    # RoI over REG_FG_THRESH; later steps' models propose elsewhere at times
    fg_steps = [s["it"] for s in steps if name == "second_iou" or s["rcnn_reg_loss"] > 0]
    if bad or steps[0]["it"] not in fg_steps:
        fail(f"{name} train steps {bad} did not launch B1 {TWO_STAGE_B1_PER_STEP} times and the "
             f"tensor-core B2 {b2_step} times, or the first step had no RoI over "
             f"REG_FG_THRESH (steps with one: {fg_steps})")
    for st, extent in zip(steps, extents[::TWO_STAGE_B1_PER_STEP]):
        st["proposal_extent_m"], st["proposal_extent_p99_m"], st["proposals_beyond_range"] = \
            extent.tolist()
    log(f"[two_stage] {name} train steps' proposals reach (largest, 99th percentile, share "
        f"beyond the range's {reach} m) "
        + ", ".join(f"{st['proposal_extent_m']:.1f} / {st['proposal_extent_p99_m']:.1f} m / "
                    f"{st['proposals_beyond_range']:.4f}" for st in steps)
        + f"; steps with a RoI over REG_FG_THRESH: {fg_steps}")
    far = [(st["it"], st["proposal_extent_p99_m"]) for st in steps
           if not st["proposal_extent_p99_m"] <= TWO_STAGE_EXTENT_FACTOR * reach]
    if far:
        fail(f"{name} training ran away: the 99th percentile of steps' proposals reaches "
             f"(step, m) {far}, beyond {TWO_STAGE_EXTENT_FACTOR} x the point-cloud range's "
             f"{reach} m")
    tstep = make_train_step(model, state.optimizer, device=device, dtype=torch.bfloat16)
    profile = two_stage_profile(f"{name}_train", model, lambda bt: float(tstep(bt)["loss"]),
                                gt_batches[:3], state.optimizer)
    seconds["train"] = time.perf_counter() - t0
    ms = [s["host_ms"] for s in steps]
    summary = {
        "config": f"tools/{two_stage_cfg_file(name)}", "card": card,
        "serve": {**serve, "b1_served": [{k: e[k] for k in (
            "problem", "shape", "ms", "plain_ms", "bound_ms", "bound_by", "survivor_share",
            "overlapping_share")} for e in served_b1],
                  "b2_served": {**served_b2[0], "per_conv": compact_gemm(served_b2[1])}},
        "train": {"batch": b, "steps": steps, "ms_per_step": {"median": statistics.median(ms),
                                                              "all": ms},
                  "samples_per_s": b / (statistics.median(ms) / 1e3),
                  "peak_memory_gib": peak / 2 ** 30, "launches": launches[f"{name}_train"],
                  "gt_launches": launches[f"{name}_gt"], "steps_with_fg_rois": fg_steps,
                  "b2_launches_per_step": {
                      **b2_split, "steps": sorted({st["gather_gemm_tensor_core"]
                                                   for st in steps})},
                  "b1_train": train_b1,
                  "b2_dx": {**train_dx[0], "per_conv": compact_gemm(train_dx[1])},
                  "fp32_check": check,
                  "profile": profile},
        "phase_seconds": seconds}
    log(f"[two_stage] {name} training: B={b}, median {statistics.median(ms):.2f} ms per step "
        f"({summary['train']['samples_per_s']:.2f} samples/s), peak memory "
        f"{summary['train']['peak_memory_gib']:.2f} GiB; seconds "
        f"{json.dumps({k: round(v, 2) for k, v in seconds.items()})}")
    return summary, launches, served_b1, train_b1, served_b2, train_dx


def two_stage_phase(device, card):
    """Phase 14: SECOND-IoU, Voxel R-CNN, PV-RCNN, PartA2 and PV-RCNN++ on
    their KITTI configs at full width with seeded weights, then Voxel R-CNN
    and PartA2 from disk, in a temporary working directory whose cfgs/
    links to tools/cfgs/. Returns (summary, launches by path, served B1
    entries, train B1 entries, B2 served and dX (totals, entries) by
    model)."""
    import os

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as work:
        work = Path(work)
        (work / "cfgs").symlink_to(REPO / "tools" / "cfgs")
        os.chdir(work)
        try:
            t0 = time.perf_counter()
            root, infos = two_stage_root(work)
            summary = {"data_seconds": time.perf_counter() - t0, "card": card}
            launches, served_b1, train_b1, b2 = {}, [], [], {}
            for name in TWO_STAGE_CONVS:
                out = two_stage_model(name, root, infos, device, card)
                summary[name] = out[0]
                launches.update(out[1])
                served_b1 += out[2]
                train_b1 += out[3]
                b2[name] = {"served": out[4], "dx": out[5]}
            for name in TWO_STAGE_CLI:
                summary[f"{name}_cli"], launches[f"{name}_cli_train"], \
                    launches[f"{name}_cli_eval"] = two_stage_cli(name, root, device)
        finally:
            os.chdir(cwd)
    return summary, launches, served_b1, train_b1, b2


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
    (prcnn_train_summary, prcnn_train, prcnn_cli_train, prcnn_cli_train_eval, prcnn_train_b1,
     prcnn_evolve) = pointrcnn_train_phase(device, card)

    # 12. depth-completion training, then pipeline 2 from the trained weights
    depth_summary, depth_launches = depth_train_phase(device, card)
    depth_b1 = sum(v["iou_bev_overlap"] for v in depth_launches.values())
    depth_b2 = sum(v["gather_gemm"] for v in depth_launches.values())

    # 13. nuScenes from disk and the anchor detectors (SECOND, PointPillar multi-head)
    nusc_summary, nusc_launches, nusc_iou, nusc_served_b2, nusc_dx = nuscenes_phase(device, card)
    served_iou += nusc_iou
    nusc_b1 = sum(v["iou_bev_overlap"] for v in nusc_launches.values())
    nusc_b2 = sum(v["gather_gemm"] for v in nusc_launches.values())

    # 14. the two-stage voxel detectors (SECOND-IoU, Voxel R-CNN, PV-RCNN, PartA2,
    # PV-RCNN++) on KITTI
    two_summary, two_launches, two_b1_served, two_b1_train, two_b2 = two_stage_phase(device,
                                                                                   card)
    served_iou += two_b1_served
    two_b1 = sum(v["iou_bev_overlap"] for v in two_launches.values())
    two_b2_n = sum(v["gather_gemm"] for v in two_launches.values())

    # the device profiles of phases 10-14, after every host-clock reading
    run_deferred_profiles()
    cspn = depth_summary["cspn_fwd_bwd_device_ms"]
    for tag, prof in depth_summary["device"].items():
        busy = prof.get("device_busy_ms_per_step")
        if busy:
            prof["cspn_share_of_busy"] = cspn / busy if tag != "enet" else 0.0
    log(f"[depth_train] ({card}) device busy per bf16 step, idle share, CSPN share: "
        + "; ".join(f"{tag} {p.get('device_busy_ms_per_step', float('nan')):.2f} ms, idle "
                    f"{p.get('device_idle_share', float('nan')):.3f}, CSPN "
                    f"{p.get('cspn_share_of_busy', float('nan')):.3f}"
                    for tag, p in depth_summary["device"].items()))

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
                     + prcnn_cli_train_eval["iou_bev_overlap"]
                     + prcnn_evolve["iou_bev_overlap"] + depth_b1 + nusc_b1 + two_b1),
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
                                 prcnn_cli_train_eval["iou_bev_overlap"],
                             "pointrcnn_evolve": prcnn_evolve["iou_bev_overlap"],
                             **{f"depth_{k}": v["iou_bev_overlap"]
                                for k, v in depth_launches.items()},
                             **{f"nuscenes_{k}": v["iou_bev_overlap"]
                                for k, v in nusc_launches.items()},
                             **{f"two_stage_{k}": v["iou_bev_overlap"]
                                for k, v in two_launches.items()}},
        "train_launches_per_step": {"pointrcnn": sorted(
            {st["iou_bev_overlap"] for st in prcnn_train_summary["steps"]}),
            "second": sorted({st["iou_bev_overlap"]
                              for st in nusc_summary["second_train"]["steps"]}),
            **{name: sorted({st["iou_bev_overlap"] for st in two_summary[name]["train"]["steps"]})
               for name in TWO_STAGE_CONVS}},
        "max_abs_err": max([iou_err] + [e["max_abs_err"]
                                        for e in served_iou + prcnn_train_b1 + two_b1_train]),
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
        "two_stage_train": two_b1_train,
    }, {
        "name": "gather_gemm",
        "route": "cuda",
        "source": "dfu3d_tpu_torch/core/voxel/csrc/gather_gemm.cu",
        "replaces": "dfu3d_tpu/core/voxel/pallas_sparse.py:77",
        "launches": (voxel_launches["gather_gemm"] + voxel_train["gather_gemm"]
                     + sum(v["gather_gemm"] for v in evolve_launches.values())
                     + prcnn_evolve["gather_gemm"] + depth_b2 + nusc_b2 + two_b2_n),
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
                             "pointrcnn_cli_train_eval": prcnn_cli_train_eval["gather_gemm"],
                             "pointrcnn_evolve": prcnn_evolve["gather_gemm"],
                             **{f"depth_{k}": v["gather_gemm"] for k, v in depth_launches.items()},
                             **{f"nuscenes_{k}": v["gather_gemm"]
                                for k, v in nusc_launches.items()},
                             **{f"two_stage_{k}": v["gather_gemm"]
                                for k, v in two_launches.items()}},
        "launches_by_variant": {k: voxel_launches[f"gather_gemm_{k}"]
                                + voxel_train[f"gather_gemm_{k}"]
                                + sum(v[f"gather_gemm_{k}"] for v in evolve_launches.values())
                                + sum(v[f"gather_gemm_{k}"] for v in nusc_launches.values())
                                + sum(v[f"gather_gemm_{k}"] for v in two_launches.values())
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
        "second_multihead": {
            "model": "cbgs_second_multihead (MeanVFE + VoxelBackBone8x, max_voxels 60000) on "
                     "synthetic nuScenes frames with 9 sweeps, bf16",
            "train_launches_per_step": {"forward": 12, "dx": VOXEL8X_TRAIN_B2 - 12},
            "shapes": [e["shape"] for e in nusc_served_b2[1] + nusc_dx[1]],
            "served_request": {"unit": "one served bf16 request: its 12 launches, summed",
                               **nusc_served_b2[0], "per_conv": nusc_served_b2[1]},
            "train_dx": {"unit": "one bf16 train step: its 11 dX launches, summed",
                         **nusc_dx[0], "per_conv": nusc_dx[1]}},
        "two_stage": {
            name: {"model": f"{two_stage_cfg_file(name)[5:]} at full width, bf16",
                   "train_launches_per_step": two_summary[name]["train"]["b2_launches_per_step"],
                   "served_request": {"unit": "one served bf16 request, summed",
                                      **two_b2[name]["served"][0]},
                   "train_dx": {"unit": "one bf16 train step's dX launches, summed",
                                **two_b2[name]["dx"][0]}}
            for name in TWO_STAGE_CONVS},
    }]
    log(json.dumps({"train": {"pillar": {"steps": pillar_steps, "launches": pillar_train},
                              "voxel": {"steps": voxel_steps, "launches": voxel_train},
                              "fp32_kernels_vs_plain": train_checks}}))
    log(json.dumps({"cli": cli_summary}, default=str))
    log(json.dumps({"pseudo": pseudo_summary}))
    log(json.dumps({"evolve": evolve_summary}, default=str))
    log(json.dumps({"pointrcnn": prcnn_summary}, default=str))
    log(json.dumps({"pointrcnn_train": prcnn_train_summary}, default=str))
    log(json.dumps({"depth_train": depth_summary}, default=str))
    log(json.dumps({"nuscenes": nusc_summary}, default=str))
    log(json.dumps({"two_stage": two_summary}, default=str))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
