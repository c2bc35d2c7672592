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
              working directory: data.nuscenes_synthetic writes 8 train + 4
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
              writes 8 train + 4 val frames of Car, Pedestrian and Cyclist,
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
 15. fully_sparse  VoxelNeXt (cbgs_voxel0075_voxelnext, its double flip,
              voxelnext_ioubranch_large) and PillarNet (KITTI, Waymo) at full
              width with seeded weights on phase 13's nuScenes root, phase
              14's KITTI root or frames made in memory: requests and bf16
              train steps with their B1 and B2 launches (FULLY_SPARSE_B2),
              every served and dX B2 call held and timed, the fp32 request
              and step through the kernels against the twins, VoxelNeXt and
              PillarNet KITTI through tools.train and tools.test.
 16. transfusion  TransFusion-L (transfusion_lidar: VoxelResBackBone8x,
              BaseBEVBackbone to 512 channels at 180 x 180, TransFusionHead
              with 200 queries) at full width with seeded weights on phase
              13's nuScenes root written anew: 4 requests of B=4 (bf16, the
              first request's BN statistics), fatal unless each launches B1
              once (the recall; predict runs no NMS) and the tensor-core B2
              21 times; spans, peak memory; the served B1 and B2 calls held
              and timed; one fp32 request through the kernels and through
              the twins on a batch whose points cover the whole range
              (query classes and cells, keep masks and labels equal, boxes
              within 1e-4); one bf16 step's 21 forward and 20 dX B2 calls
              held and timed; the fp32 step through the kernels against the
              twins (the regression branches' gradients nonzero); 4 bf16
              steps through trainer.train_model, fatal unless each
              launches the tensor-core B2 41 times and B1 never; the host
              Hungarian's ms; tools.train (1 epoch, 2 steps) and tools.test
              on the root. Device busy and idle of a request and of a step
              with the deferred profiles.
 17. dsvt     DSVT-Pillar and DSVT-Voxel (waymo_models/dsvt_pillar.yaml,
              dsvt_voxel.yaml: DynamicVoxelVFE, the DSVT trunk at d_model
              192, 8 heads, MAX_SETS 1024, the 468 x 468 (x 32) grid,
              BaseBEVBackbone to 384 channels, CenterHead at stride 1) at
              full width with seeded weights on zoo.waymo_batches (150,000
              points per frame): 3 requests of B=4 (bf16), fatal unless
              each launches B1 twice (NMS, recall) and B2 never; spans,
              peak memory and the share of each frame's voxels that reach a
              set in each layer; the served B1 calls held and timed; one
              fp32 request through the kernels and through the twins; the
              fp32 step through the kernels against the twins; 3 bf16 steps
              through trainer.train_model, fatal unless each launches
              neither kernel. Device busy and idle of a request and of a
              step with the deferred profiles.
 18. mppnet   MPPNet on mppnet_4frames.yaml and mppnet_16frames.yaml and
              MPPNetE2E on mppnet_e2e_memorybank_inference.yaml (the Waymo
              SECOND first stage over 1504 x 1504 x 40 with 150,000 voxels,
              the trajectory head at HIDDEN 256, 3 layers, 64 proxies, 128
              points per frame and RoI) at full width with seeded weights
              on zoo.waymo_sequence_batches (B=2, 150,000 points per frame,
              moving boxes; the E2E requests one sequence 0.1 s apart):
              3 / 2 / 3 requests (bf16; the E2E model through its memory
              bank), fatal unless each launches B1 T + 1 times (NMS, T - 1
              trajectory matches, recall; the E2E model's bank match one
              more) and the tensor-core B2 12 times, or on an E2E sequence
              whose bank never matches; spans with the dead frames' share
              of the head, peak memory, the bank's matched share per
              request; the served B1 and B2 calls held and timed; one fp32
              request (the E2E model: two requests through the bank)
              through the kernels and through the twins, the twins' run
              held on the kernel run's proposals once they agree within
              1e-4 of their scale (the head's crop circles and balls make
              it step with its boxes); at the seeded weights each train
              batch's gt made once (zoo.proposal_gt), the train forward's
              B1 calls and one bf16 step's 11 dX B2 calls held and timed,
              the fp32 step through the kernels against the twins on the
              same proposals (the joint regression's gradient nonzero);
              3 / 2 / 2 bf16 steps through trainer.train_model, fatal
              unless each launches B1 T + 1 times (NMS, trajectory, RoI
              targets) and the tensor-core B2 23 times, or on a non-finite
              loss or gradient. Device busy and idle of a request and of a
              step with the deferred profiles.
 19. camera   BEVFusion, CaDDN and the focal multimodal Voxel R-CNN at full
              width with seeded weights on zoo.camera_batches: requests and
              bf16 steps with their B1 and B2 launches, the fp32 checks, the
              device profiles (DEVICE_PROFILED).
 20. datasets the other lidar datasets from disk through the CLIs, in a
              temporary working directory whose cfgs/ links to tools/cfgs/:
              a synthetic Waymo root in the extracted layout (2 train
              sequences of 20 frames, 8 read at SAMPLED_INTERVAL 5, and 4
              val frames; 150,000 points in 6 columns, 5 % NLZ), tools.train
              of waymo_models/centerpoint.yaml for 1 epoch (B=4, bf16; fatal
              unless each step launches the tensor-core B2 41 times and B1
              never) and tools.test of its checkpoint (B1 2 and B2 21 per
              batch; the KITTI-protocol AP through WAYMO_TO_KITTI), then one
              bf16 request of the disk batch at seeded weights (its BN
              statistics) with its B1 and B2 calls held and timed and the
              fp32 request through the kernels against the twins on the
              same top-500 peaks; a synthetic ONCE root (8 + 4 frames
              of 60,000 points), create_once_infos, the gt database,
              tools.train of once_models/centerpoint.yaml with gt sampling
              and tools.test (once_eval); tools.test of seeded checkpoints of
              lyft_models/cbgs_second_multihead.yaml (the Lyft mAP),
              custom_models/second.yaml and argo2_models/
              cbgs_voxel01_voxelnext.yaml (the KITTI fallback) on 4 frames
              each. Per dataset host seconds, ms per request and step,
              points kept per frame, peak memory.
 21. options  the seven configs derived from shipped ones (zoo.option_cfg:
              CenterPoint with BaseBEVResBackbone, per-tower heads and
              circle NMS; SECOND with USE_IOU_HEAD and MATCH_HEIGHT; the
              compact RoI schemas of Voxel R-CNN, PV-RCNN, PV-RCNN++ and
              PartA2; VoxelNeXt's compact trunk) at full width with seeded
              weights, bf16, on a synthetic nuScenes root (4 + 4 key
              frames, 9 sweeps) and a KITTI root with random RGB PNGs
              (8 + 4 frames): requests and train steps, each fatal unless
              it launches B1 and B2 as OPTIONS_B1 and OPTIONS_B2 say (B1
              inside SECOND's train step: MATCH_HEIGHT's assignment); the
              fp32 requests of centerpoint_options, voxel_rcnn_compact and
              voxelnext_compact through the kernels against the twins;
              SECOND's fp32 train step against the twins (MATCH_HEIGHT's
              labels equal, conv_iou's gradient nonzero) and its B1 call
              held and timed; VoxelNeXt's 52 served B2 calls held and
              timed; SECOND from disk through tools.train and tools.test;
              CaDDN.yaml's image items, and frames/s of get_image and of
              the whole item on the host.
 22. aux      zoo.second_column (KITTI second.yaml with its VoxelBackBone8x
              in the column formulation: 1408 x 1600 x 40, 40,000 / 16,000
              columns, AnchorHeadSingle over 3 classes) at full width with
              seeded weights (the first request's BN statistics), bf16, on
              a synthetic KITTI root (8 + 4 frames): 3 requests and 3 train
              steps, fatal unless each launches B1 2 / 0 times and B2
              never; second.yaml in the gather form with the same weights
              on the same batches (B2 12 / 23), host ms, device-busy ms and
              peaks of both; the fp32 request of each form compared, every
              stage's columns and voxels against their caps (the trunks'
              output sets, the head maps, every anchor's decoded box and
              score, the NMS in one score order; fatal where no cap binds;
              where one does, with both forms at 160,000 voxels, where none
              binds),
              and the fp32
              column request through B1 against
              its twin; tools.demo's predict_files on 4 .bin files with a
              saved checkpoint (B1 once per file, PNGs where matplotlib
              imports); profiling.trace around a column request (fatal
              unless the trace names the span and B1's kernel) and
              StepTimer; tools.create_integrated_database on the root's gt
              database.
 23. dist     data parallelism over torch.distributed (`parallel`): the
              flagship's 2 fp32 steps in a world-1 NCCL group, and as one
              steps_per_dispatch-2 call, equal to the plain steps bit for
              bit; 2 spawned ranks over gloo sharing the card (the
              collectives staged through the host), B=4 each, train the
              flagship and voxel CenterPoint 2 fp32 steps on their rows of
              global batches of 8, held against one process on the joined
              batches (`dist_compare`; voxel CenterPoint's with cuDNN
              off), the ranks' states bit-equal, B2 41
              times per voxel step on each rank; 3 timed bf16 steps of each
              world after a warm-up, peaks per rank; the 2-rank eval epoch
              over an odd-sized synthetic KITTI val split (9 frames) merged
              across the ranks, against the 1-rank one: the padded
              duplicate, the kept boxes, the AP, B1 twice per eval step on
              each rank.
The lines before the last are {"cli": {...}}, {"pseudo": {...}},
{"evolve": {...}}, {"pointrcnn": {...}}, {"pointrcnn_train": {...}},
{"depth_train": {...}}, {"nuscenes": {...}}, {"two_stage": {...}},
{"fully_sparse": {...}}, {"transfusion": {...}}, {"dsvt": {...}},
{"mppnet": {...}}, {"camera": {...}}, {"datasets": {...}},
{"options": {...}}, {"aux": {...}}, {"distributed": {...}} and
{"kernels": [...]};
the last line is {"ok": true, "device": {...}}.
"""
import contextlib
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
TRAIN_STEPS = 2           # train steps per model in phase 6
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


def served_overlap_problems(model, batch, device, names=("nms", "recall"), step=None):
    """The overlap calls of one served bf16 request (`step(batch)`, by
    default the bf16 eval step), recorded in order and named by `names`:
    [("nms", corners_a, corners_b), ("recall", ...)] for CenterPoint;
    PointRCNN makes three (proposal NMS, final NMS, recall)."""
    import torch

    from dfu3d_tpu_torch.core.geometry import iou_kernel
    from dfu3d_tpu_torch.train.train_state import make_eval_step

    calls = []
    kernel_fn = iou_kernel.overlap_bev
    step = step or make_eval_step(model, RECALL_THRESH, device=device, dtype=torch.bfloat16)

    def recording(ca, cb):
        calls.append((ca, cb))
        return kernel_fn(ca, cb)

    iou_kernel.overlap_bev = recording
    try:
        step(batch)
    finally:
        iou_kernel.overlap_bev = kernel_fn
    torch.cuda.synchronize()
    if len(calls) != len(names):
        fail(f"one served request made {len(calls)} overlap calls, not {len(names)} "
             f"({', '.join(names)})")
    return [(name, ca, cb) for name, (ca, cb) in zip(names, calls)]


def time_served_overlaps(path, model, batch, device, names=("nms", "recall"), step=None):
    """Each overlap call of one served request (`served_overlap_problems`),
    held against the plain twin (fatal on a miss) and timed beside its
    bound. The plain twin computes a large problem in blocks of about 2^20
    pairs (rows of A against all of B), so (4, 4096, 4096) fits."""
    import torch

    from dfu3d_tpu_torch.core.geometry import iou_kernel

    entries = []
    for name, ca, cb in served_overlap_problems(model, batch, device, names, step):
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
    match_err = set_match_err(name, (kb, ks, kl, kv), (pb, ps, pl, pv))
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


def set_match_err(name, kernel_out, plain_out):
    """The largest difference of the kept (box, score, label) rows of two
    outputs (boxes, scores, labels, valid) matched one to one per sample
    (fatal if they do not match one to one)."""
    import torch

    (kb, ks, kl, kv), (pb, ps, pl, pv) = kernel_out, plain_out
    match_err = 0.0
    for i in range(kb.shape[0]):
        rows_k = torch.cat([kb[i], ks[i, :, None], kl[i, :, None].float()], -1)[kv[i]]
        rows_p = torch.cat([pb[i], ps[i, :, None], pl[i, :, None].float()], -1)[pv[i]]
        if not len(rows_k) and not len(rows_p):
            continue
        dist = (rows_k[:, None, :] - rows_p[None, :, :]).abs().amax(-1)
        match = dist.argmin(0)
        if len(set(match.tolist())) != len(match):
            fail(f"{name} fp32 path: the kept boxes of sample {i} do not match one to one")
        match_err = max(match_err, dist[match, torch.arange(len(match))].max().item())
    return match_err


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
    miss or on another variant than the one its dtype and widths take,
    `gather_gemm_kernel.variant`: the tensor-core one at every bf16 width of
    the paths but K = 125) and timed: kernel, plain, library, bound.
    Returns (totals, entries)."""
    import torch

    from dfu3d_tpu_torch.core.voxel import gather_gemm_kernel as gk

    entries = []
    for name, args in named_calls:
        got, ran = launch_variant(lambda: gk.gather_gemm(*args))
        torch.cuda.synchronize()
        k, cin, cout = args[3].shape
        want = gk.variant(args[0].dtype, k, gk.padded_cin(args[0].dtype, k, cin, cout), cout)
        e = {"conv": name, "shape": [list(args[0].shape), list(args[2].shape),
                                     list(args[3].shape)], "variant": ran,
             **gemm_agreement(args, got, gk.gather_gemm_plain(*args))}
        if not e.pop("ok") or ran != want:
            fail(f"gather-GEMM {label}, {name}: {e} (want the {want} variant)")
        entries.append(time_gemm(e, *args, reps=10))
    total = {k: sum(e[k] for e in entries) for k in ("ms", "plain_ms", "library_ms")}
    by = {"bytes": 0.0, "operations": 0.0}
    for e in entries:
        by[e["bound_by"]] += e["bound_ms"]
    total.update(bound_ms=sum(by.values()), bound_by=max(by, key=by.get), launches=len(entries),
                 max_err_over_tol=max(e["max_err_over_tol"] for e in entries))
    variants = {v: sum(e["variant"] == v for e in entries) for v in ("tensor_core", "cuda_core")}
    total["launches_by_variant"] = variants
    log(f"[kernels] gather_gemm {label} ({len(entries)} launches, {variants['tensor_core']} "
        f"tensor-core and {variants['cuda_core']} CUDA-core, each within "
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
        f"{statistics.median(ms[1:] or ms):.2f} ms); checkpoint reloaded equal "
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


def check_dx_mirrors(convs, fwd, dx, first_has_dx=False):
    """Fatal unless each dX call mirrors its forward call: the backward runs
    the convs (`convs`, forward order) in reverse, with the transposed
    weights, and the first conv's input needs no dX unless `first_has_dx`
    (PillarNet's: its pillar VFE trains)."""
    if len(fwd) != len(convs) or len(dx) != len(convs) - (0 if first_has_dx else 1):
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
POINTRCNN_REQUESTS = 1
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
# the paths whose steps the script profiles on the device: each profile costs
# ~4.7 s of host time (CUPTI and the event lists; 183 s over phases 10-19's
# 39 steps on an H100 host); profile_serve / profile_train measure the other
# paths' busy and idle shares
DEVICE_PROFILED = ("camera",)


def defer_device_profile(tag, run):
    """Queue torch.profiler over one step, run(), for the end of the script
    (`run_deferred_profiles`), and return the dict it then fills: the card's
    busy and idle share and its top kernels. A step run after torch.profiler
    in the same process is slower on the host (`profile_train`'s
    step_ms_after_profiler), so it runs after every host-clock reading.
    Only tags of DEVICE_PROFILED paths are profiled."""
    device = {}
    if not tag.startswith(DEVICE_PROFILED):
        device["not_measured"] = ("chip_smoke.py profiles only DEVICE_PROFILED paths on the "
                                  "device; profile_serve / profile_train measure this one")
        return device

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


POINTRCNN_TRAIN_STEPS = 2
POINTRCNN_TRAIN_B1 = 2       # proposal NMS, RoI target IoU
TRAIN_OVERLAPS = ("proposal_nms", "roi_target_iou")   # a two-stage train step's B1 calls
POINTRCNN_UNIFORMS_SEED = 0  # the fp32 check's RoI sampler draws


def train_overlaps(path, model, batch, device, coord_tol=False, names=TRAIN_OVERLAPS):
    """Each of one bf16 train step's B1 calls (the proposal NMS, over (4,
    4096, 4096) for PointRCNN and (B, 9000, 9000) for the two-stage voxel
    detectors; the RoI targets' 3D IoU over (B, R, G)), recorded from a
    forward in train mode, held against the plain twin on its own inputs
    (fatal on a miss) and timed beside its bound (the twin 3 times: at
    (4, 9000, 9000) it takes seconds); `names` names the calls in order
    (MPPNet's trajectory matches come between the two). With `coord_tol`
    each pair's
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
    if len(calls) != len(names):
        fail(f"one {path} train forward made {len(calls)} B1 calls, not {len(names)} "
             f"({', '.join(names)})")
    entries = []
    for name, (ca, cb) in zip(names, calls):
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


# phase 13's synthetic nuScenes key frames (also phases 15 and 16's): 8 train
# frames for the 2 bf16 steps of B=4, 4 val frames for one request; cut from
# 16 + 8 to keep the whole script within its time limit with phase 20
NUSC_TRAIN_FRAMES, NUSC_VAL_FRAMES = 8, 4
NUSC_SWEEPS = 10                             # MAX_SWEEPS of the nuScenes configs
NUSC_REQUESTS = 1                            # SECOND serving, B=4 each
NUSC_PP_REQUESTS = 2                         # PointPillar multi-head serving
NUSC_TRAIN_STEPS = 2
NUSC_LAG_MAX = 0.45                          # s, the ninth sweep's time lag
NUSC_PROFILE_DEPTH = "2"                     # profile_serve batches, profile_train steps
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


def nuscenes_cli(root, cfg_file, b2_train, b2_eval, device, b1_eval=2, extra_sets=()):
    """tools.train (1 epoch, bf16) and tools.test of its checkpoint on a
    nuScenes config from `root`, gt sampling disabled (no nuScenes gt
    database exists); fatal unless every train step launched the
    tensor-core B2 `b2_train` times and no B1, the eval launched B2
    `b2_eval` and B1 `b1_eval` times per batch, results came back for every
    val frame and the AP_DICT holds the ten classes; `extra_sets` adds
    --set pairs. Returns the summary and the launches of training and
    evaluation."""
    from dfu3d_tpu_torch.tools import test as test_cli, train as train_cli

    sets = ["--set", "DATA_CONFIG.DATA_PATH", str(root),
            "DATA_CONFIG.DATA_AUGMENTOR.DISABLE_AUG_LIST", "gt_sampling", *extra_sets]
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
            eval_launches["iou_bev_overlap"] != b1_eval * batches:
        fail(f"tools.test {tag}: {result['num_frames']} frames of {NUSC_VAL_FRAMES}, classes "
             f"{sorted(classes)}, {batches} batches, kernel launches {eval_launches}")
    summary = {"train_steps": steps, "train_s": train_s, "train_loss": out["epochs"][0]["loss"],
               "train_launches": train_launches, "eval_s": eval_s, "eval_batches": batches,
               "eval_launches": eval_launches, "eval_frames": result["num_frames"],
               "gt_num": result["gt_num"],
               "car_3d_moderate_R40": result["Car_3d/moderate_R40"],
               "time_split_s": {k: result[k] for k in result if k.startswith("time/")}}
    log(f"[nuscenes] {tag} from disk: tools.train {steps} steps ({NUSC_TRAIN_FRAMES} frames"
        f"{'' if extra_sets else ', class-balanced resampling'}) in {train_s:.2f} s, "
        f"loss {out['epochs'][0]['loss']:.4f}, "
        f"launches {json.dumps(train_launches)}; tools.test {result['num_frames']} frames in "
        f"{eval_s:.2f} s, AP_DICT with {len(classes)} classes, launches "
        f"{json.dumps(eval_launches)}")
    return summary, train_launches, eval_launches


def nuscenes_profiles(summary):
    """profile_serve --model second and profile_train --model second, each in
    a process of its own, run with the deferred profiles after every
    host-clock reading; their spans and device profiles go into
    `summary`. This process's cached, unused device memory is released
    first: the allocator keeps the high-water mark of the phases before
    (tens of GiB after phase 18's fp32 16-frame step), which the
    processes need."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    for tool, flag, key in (("profile_serve", "--batches", "profile_serve"),
                            ("profile_train", "--steps", "profile_train")):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as work:
            out = Path(work) / f"{key}.json"
            run = subprocess.run([sys.executable, "-m", f"dfu3d_tpu_torch.{tool}", "--model",
                                  "second", flag, NUSC_PROFILE_DEPTH, "--out", str(out)],
                                 cwd=REPO,
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


# per model: served requests of B=4, bf16 train steps; all cut to 2 and 3
# to keep the whole script within its time limit (with PartA2 and
# PV-RCNN++ at 4 and 5, and phase 15 added, it took 1,027 s)
TWO_STAGE_DEPTH = {"second_iou": (1, 2), "voxel_rcnn": (1, 2), "pv_rcnn": (1, 2),
                   "parta2": (1, 2), "pv_rcnn_plusplus": (1, 2)}
TWO_STAGE_FRAMES = (8, 4)   # phase 14's (and 15's) synthetic KITTI root: train, val (from 16, 8)
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


def check_two_stage_train_paths(name, model, batch, device, reg_prefix=None):
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
    zero, the RoI head's regression branch (`reg_prefix`, by default
    TWO_STAGE_REG[name]) among them. The twin's fp32 sums
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
           if k.startswith(reg_prefix or TWO_STAGE_REG[name])}
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


# phase 15: per model, served requests of B=4 and bf16 train steps of B=4
FULLY_SPARSE_DEPTH = {"voxelnext": (1, 2), "voxelnext_tta": (1, 0),
                      "voxelnext_iou_large": (1, 2), "pillarnet": (1, 2),
                      "pillarnet_waymo": (1, 2)}
# B2 launches per request and per train step, worked out from the JAX
# modules: VoxelNeXt runs 30 trunk convs (conv_input, two residual blocks of
# two, five stages of a strided conv and two residual blocks), conv_out,
# shared_conv and one conv per head branch (num_conv 2), 6 groups x 6
# branches on nuScenes (36) and 6 branches on the large Waymo config; a
# step adds one dX per conv but conv_input's (the voxel means need no
# gradient). PillarNet's pyramids run 12 (PillarBackBone8x) and 21
# (PillarRes18BackBone8x) convs, and its pillar VFE trains, so every conv
# has a dX. voxelnext_iou_large's two 5 x 5 x 5 downs (125 taps) take the
# CUDA-core variant, forward and dX; every other call the tensor cores.
FULLY_SPARSE_B2 = {"voxelnext": (68, 135), "voxelnext_tta": (68, 0),
                   "voxelnext_iou_large": (38, 75), "pillarnet": (12, 24),
                   "pillarnet_waymo": (21, 42)}
FULLY_SPARSE_CUDA_CORE = {"voxelnext_iou_large": (2, 4)}
# the models served with the first request's BN statistics
# (flagship.calibrate_bn_): VoxelNeXt reads raw point means (intensities up
# to 255) into 31 residual convs, whose identity BN overflows its exp'd
# dims; PillarNet KITTI's seeded anchor scores sit within 6e-8 of 0.5 at
# identity BN and spread with them. PillarNet Waymo keeps identity BN: with
# the statistics (variances floored at 1) its CenterHead's logits compress
# to ±0.15 and top-K's 500th place falls among near-ties, while at identity
# its boxes through two tap orders agree to 3e-5 (CPU, fp32)
FULLY_SPARSE_CALIBRATED = ("voxelnext", "voxelnext_tta", "voxelnext_iou_large", "pillarnet")
FULLY_SPARSE_B1 = (2, 0)   # per request (NMS, recall) and per train step
FS_UNITS = {"served": "one served bf16 request, its launches summed",
            "dx": "one bf16 train step, its dX launches summed"}
VOXELNEXT_CFG = "cfgs/nuscenes_models/cbgs_voxel0075_voxelnext.yaml"   # from phase 15's work dir
PILLARNET_CFG = "cfgs/kitti_models/pillarnet.yaml"
# a regression branch per model, whose weights the fp32 train check requires a gradient on
FULLY_SPARSE_REG = {"voxelnext": ("head_0.center_out.", "head_0.vel_out."),
                    "voxelnext_iou_large": ("head_0.center_out.", "head_0.iou_out."),
                    "pillarnet": ("dense_head.conv_box.",),
                    "pillarnet_waymo": ("dense_head.fused_heads.out.",)}


def fully_sparse_serve(name, model, batches, device, tag="fully_sparse"):
    """A warm-up request, the peak memory and every kernel count set to 0,
    the requests through eval_batches (bf16), the counts and the peak read.
    Fatal unless every request launched B1 twice and B2 as FULLY_SPARSE_B2
    (DSVT_B2) and FULLY_SPARSE_CUDA_CORE say, or on a non-finite, misshapen
    or empty output (the double-flip's kept boxes included). Returns
    (EvalResult, launches, summary)."""
    import torch

    from dfu3d_tpu_torch.train.eval_utils import eval_batches

    eval_batches(model, batches[:1], RECALL_THRESH, device=device, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res = eval_batches(model, batches, RECALL_THRESH, device=device, dtype=torch.bfloat16)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    n = len(batches)
    b2 = {**FULLY_SPARSE_B2, **DSVT_B2}[name][0]
    cuda_core = FULLY_SPARSE_CUDA_CORE.get(name, (0, 0))[0]
    post_max = int(model.model_cfg.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE)
    for k, (boxes, scores, labels, valid) in enumerate(res.preds):
        if boxes.shape[:2] != (4, post_max) or not torch.isfinite(boxes[valid]).all() or \
                not torch.isfinite(scores).all() or not valid.any(dim=1).all():
            fail(f"{name} request {k}: boxes {tuple(boxes.shape)}, kept boxes finite "
                 f"{bool(torch.isfinite(boxes[valid]).all())}, kept per frame "
                 f"{valid.sum(1).tolist()}")
    if launches["iou_bev_overlap"] != FULLY_SPARSE_B1[0] * n or \
            launches["gather_gemm"] != b2 * n or launches["gather_gemm_cuda_core"] != cuda_core * n:
        fail(f"{name} serving: kernel launches {launches} for {n} requests, not "
             f"{FULLY_SPARSE_B1[0]} B1 and {b2} B2 ({cuda_core} of them CUDA-core) per request")
    ms = [s * 1e3 for s in res.batch_seconds]
    summary = {"request_ms": {"median": statistics.median(ms), "all": ms},
               "kept_per_frame": [p[3].sum(1).tolist() for p in res.preds],
               "recall": res.metric, "launches": launches,
               "launches_per_request": {k: v / n for k, v in launches.items()},
               "peak_memory_gib": peak / 2 ** 30}
    log(f"[{tag}] {name} serving, {n} requests of B=4 (bf16): ms per request median "
        f"{summary['request_ms']['median']:.2f} (all: {', '.join(f'{v:.2f}' for v in ms)}); "
        f"peak memory {summary['peak_memory_gib']:.2f} GiB; kept per frame "
        f"{summary['kept_per_frame']}; launches per request "
        f"{json.dumps(summary['launches_per_request'])}")
    return res, launches, summary


def fully_sparse_batches(name, cfg, data, count, training):
    """`count` batches of B=4 for a phase 15 model: nuScenes key frames with
    9 sweeps from phase 15's root (VoxelNeXt's nuScenes configs), KITTI
    frames from phase 15's KITTI root (PillarNet's KITTI config), or frames
    made in memory in the config's range (the Waymo configs,
    `zoo.waymo_batches`, 150,000 points and 20-40 boxes each)."""
    from dfu3d_tpu_torch import zoo

    if name.startswith("voxelnext") and name != "voxelnext_iou_large":
        root, infos = data["nuscenes"]
        return zoo.nuscenes_batches(cfg, root, infos["train" if training else "val"], count,
                                    training=training)
    if name == "pillarnet":
        root, infos = data["kitti"]
        return zoo.kitti_batches(cfg, root, infos["train" if training else "val"], count, 4,
                                 training=training)
    return zoo.waymo_batches(cfg, count, seed=1 if training else 0)


def fully_sparse_model(name, data, device, card):
    """Phase 15 for one model: serving at seeded weights (with the BN
    statistics of the first request, `flagship.calibrate_bn_`, where
    FULLY_SPARSE_CALIBRATED says; launches, ms, peak memory, spans,
    the served B1 and B2 calls held and timed, the fp32 request through the
    kernels and through the twins), then at the seeded weights one bf16
    step's B2 calls (forward and dX) held and timed and the fp32 step
    through the kernels and through the twins, then FULLY_SPARSE_DEPTH's
    bf16 steps through train_model (launches, ms, peak memory, spans).
    Returns (summary, launches by path, served B1 entries, B2 entries by
    path)."""
    import torch

    from dfu3d_tpu_torch import profile_serve, zoo
    from dfu3d_tpu_torch.core.geometry import iou_kernel
    from dfu3d_tpu_torch.core.voxel import gather_gemm_kernel
    from dfu3d_tpu_torch.flagship import calibrate_bn_, seeded_weights_
    from dfu3d_tpu_torch.profile_serve import _run
    from dfu3d_tpu_torch.train.train_state import make_eval_step, make_train_step

    build = getattr(zoo, name)
    requests, train_steps = FULLY_SPARSE_DEPTH[name]
    swaps = [(iou_kernel, "overlap_bev", "overlap_bev_plain"),
             (gather_gemm_kernel, "gather_gemm", "gather_gemm_plain")]
    seconds, launches, b2 = {}, {}, {}
    t0 = time.perf_counter()
    cfg, grid, model = build(device=device)
    seeded_weights_(model, seed=0)
    batches = fully_sparse_batches(name, cfg, data, requests, training=False)
    if name in FULLY_SPARSE_CALIBRATED:
        calibrate_bn_(model, batches[0])
    seconds["setup_serve"] = time.perf_counter() - t0
    log(f"[fully_sparse] {name}: {cfg.MODEL.NAME} ({type(model).__name__}) "
        f"{'x'.join(map(str, grid.grid_size))} grid, max_voxels "
        f"{profile_serve.cfg_max_voxels(model)}, {sum(p.numel() for p in model.parameters())} "
        f"parameters; points per request {[b.points_valid.sum(1).tolist() for b in batches]}")

    t0 = time.perf_counter()
    res, launches[name], serve = fully_sparse_serve(name, model, batches, device)
    step = make_eval_step(model, RECALL_THRESH, device=device, dtype=torch.bfloat16)
    serve["profile"] = profile_serve.fully_sparse_profile(model, lambda b: _run(step, b),
                                                          batches[:2])
    serve["profile"]["device_time"] = defer_device_profile(f"fully_sparse {name}",
                                                           lambda: _run(step, batches[0]))
    served_b1 = time_served_overlaps(name, model, batches[0], device)
    calls = record_gemm_calls(lambda: step(batches[0]))
    if len(calls) != FULLY_SPARSE_B2[name][0]:
        fail(f"one {name} eval step made {len(calls)} gather-GEMM calls, not "
             f"{FULLY_SPARSE_B2[name][0]}")
    b2["served"] = hold_gemm_calls(f"{name}, one served request",
                                   ((f"conv{i}", c) for i, c in enumerate(calls)))
    del calls
    serve["fp32_check"] = check_paths(name, model, cfg, batches[0], res.preds[0], swaps, device)
    seconds["serve"] = time.perf_counter() - t0
    ph = serve["profile"]["phase_ms"]
    log(f"[fully_sparse] {name} instrumented request {ph['step']:.2f} ms; spans (ms) "
        + ", ".join(f"{k} {v:.2f}" for k, v in sorted(ph.items(), key=lambda kv: -kv[1])[1:12]))
    del res
    summary = {"config": f"tools/cfgs/{zoo.FULLY_SPARSE_CFGS[name]}", "card": card, "serve": {**serve, "b1_served": [{k: e[k] for k in (
                   "problem", "shape", "ms", "plain_ms", "bound_ms", "bound_by")}
                   for e in served_b1], "b2_served": {**b2["served"][0], "per_conv": compact_gemm(
                       b2["served"][1])}},
               "phase_seconds": seconds}
    if not train_steps:
        return summary, launches, served_b1, b2

    t0 = time.perf_counter()
    tbatches = fully_sparse_batches(name, cfg, data, train_steps, training=True)
    _, _, model = build(device=device, train=True)
    seeded_weights_(model, seed=0)
    weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    model.train()
    loss = []

    def bf16_forward():
        with torch.autocast("cuda", dtype=torch.bfloat16):
            loss.append(model(tbatches[0].to(device))[0])

    fwd = record_gemm_calls(bf16_forward)
    dx = record_gemm_calls(lambda: loss[0].backward())
    model.zero_grad(set_to_none=True)
    model.load_state_dict(weights)
    n_fwd, n_step = FULLY_SPARSE_B2[name]
    check_dx_mirrors([f"conv{i}" for i in range(n_fwd)], fwd, dx,
                     first_has_dx=n_step == 2 * n_fwd)
    b2["dx"] = hold_gemm_calls(f"dX of one {name} train step",
                               ((f"dx{i}", c) for i, c in enumerate(dx)))
    del fwd, dx, loss
    check = check_train_paths(name, model, tbatches[0], swaps, device, scales=True)
    # the weights: an L1 loss's bias gradient is a sum of ±1 and may cancel
    reg = {k: v for k, v in check.pop("leaf_scales").items()
           if k.startswith(FULLY_SPARSE_REG[name]) and k.endswith(".weight")}
    if not reg or not all(v > 0 for v in reg.values()):
        fail(f"{name} fp32 train step: a regression branch leaf has no gradient {reg}")
    check["reg_branch_grad_max"] = reg
    del model
    torch.cuda.reset_peak_memory_stats()
    model, launches[f"{name}_train"], steps, state = train(name, build, tbatches, device)
    peak = torch.cuda.max_memory_allocated()
    cc = FULLY_SPARSE_CUDA_CORE.get(name, (0, 0))[1]
    bad = [s["it"] for s in steps if s["iou_bev_overlap"] != FULLY_SPARSE_B1[1]
           or s["gather_gemm_tensor_core"] + s["gather_gemm_cuda_core"] != n_step
           or s["gather_gemm_cuda_core"] != cc]
    if bad:
        fail(f"{name} train steps {bad} did not launch B1 {FULLY_SPARSE_B1[1]} times and B2 "
             f"{n_step} times ({cc} CUDA-core): {steps}")
    tstep = make_train_step(model, state.optimizer, device=device, dtype=torch.bfloat16)

    def run_train(bt):
        return float(tstep(bt)["loss"])

    # the train step's device time: profile_train --model <name> (no deferred
    # profile here, to keep the whole script within its time limit)
    profile = profile_serve.fully_sparse_profile(model, run_train, tbatches[:2], state.optimizer)
    seconds["train"] = time.perf_counter() - t0
    ms = [s["host_ms"] for s in steps]
    summary["train"] = {
        "batch": 4, "steps": steps, "ms_per_step": {"median": statistics.median(ms), "all": ms},
        "samples_per_s": 4 / (statistics.median(ms) / 1e3), "peak_memory_gib": peak / 2 ** 30,
        "launches": launches[f"{name}_train"],
        "b2_launches_per_step": {"forward": n_fwd, "dx": n_step - n_fwd},
        "b2_dx": {**b2["dx"][0], "per_conv": compact_gemm(b2["dx"][1])},
        "fp32_check": check, "profile": profile}
    ph = profile["phase_ms"]
    log(f"[fully_sparse] {name} training: B=4, median {statistics.median(ms):.2f} ms per step "
        f"({summary['train']['samples_per_s']:.2f} samples/s), peak memory "
        f"{peak / 2 ** 30:.2f} GiB; instrumented step {ph['step']:.2f} ms, spans (ms) "
        + ", ".join(f"{k} {v:.2f}" for k, v in sorted(ph.items(), key=lambda kv: -kv[1])[1:12]))
    return summary, launches, served_b1, b2


def pillarnet_cli(root, device):
    """PillarNet's KITTI config from disk: tools.train for 1 epoch (phase
    15's 8 train frames, B=4, gt sampling and the world augmentations,
    bf16) and tools.test --ckpt of its checkpoint on the val split; fatal
    on a non-finite loss, no checkpoint, a train step that does not launch
    the tensor-core B2 24 times and no B1, an eval batch that does not
    launch B1 twice and B2 12 times, a missing KITTI txt or no Car in the
    AP_DICT."""
    from dfu3d_tpu_torch.tools import test as test_cli, train as train_cli

    common = ["--cfg_file", PILLARNET_CFG, "--workers", str(LOADER_WORKERS), "--extra_tag",
              "chip_smoke"]
    data_path = ["--set", "DATA_CONFIG.DATA_PATH", str(root)]
    n_fwd, n_step = FULLY_SPARSE_B2["pillarnet"]
    reset_launches()
    t0 = time.perf_counter()
    trained = train_cli.main([*common, "--epochs", "1", *data_path])
    train_s = time.perf_counter() - t0
    train_launches = read_launches()
    (epoch,) = trained["epochs"]
    ckpt = trained["ckpt_dir"] / "checkpoint_epoch_1.pth"
    if not epoch["steps"] or not all(math.isfinite(v) for v in epoch["losses"]) or \
            not ckpt.exists() or train_launches["iou_bev_overlap"] or \
            train_launches["gather_gemm_tensor_core"] != n_step * epoch["steps"] or \
            train_launches["gather_gemm_cuda_core"]:
        fail(f"tools.train {PILLARNET_CFG}: {epoch}, checkpoint {ckpt.exists()}, kernel "
             f"launches {train_launches} (want {n_step} tensor-core B2 per step, no B1)")
    reset_launches()
    t0 = time.perf_counter()
    ((_, result_dir, res),) = test_cli.main([*common, "--ckpt", str(ckpt), "--save_to_file",
                                             *data_path])
    test_s = time.perf_counter() - t0
    eval_launches = read_launches()
    txts = len(list((result_dir / "final_result" / "data").glob("*.txt")))
    batches = res["eval_batches"]
    if txts != TWO_STAGE_FRAMES[1] or "Car_3d/moderate_R40" not in res or \
            eval_launches["iou_bev_overlap"] != FULLY_SPARSE_B1[0] * batches or \
            eval_launches["gather_gemm_tensor_core"] != n_fwd * batches:
        fail(f"tools.test {PILLARNET_CFG}: {txts} txts for {TWO_STAGE_FRAMES[1]} val frames, "
             f"kernel launches {eval_launches} for {batches} batches")
    log(f"[fully_sparse] pillarnet from disk: tools.train {epoch['steps']} steps, losses "
        f"{[round(v, 4) for v in epoch['losses']]}, {train_s:.2f} s, launches "
        f"{json.dumps(train_launches)}; tools.test {res['num_frames']} frames, {txts} KITTI "
        f"txts, {test_s:.2f} s, Car 3D moderate R40 {res['Car_3d/moderate_R40']:.2f}, launches "
        f"{json.dumps(eval_launches)}")
    return ({"train": {"steps": epoch["steps"], "losses": epoch["losses"], "seconds": train_s,
                       "launches": train_launches},
             "eval": {"num_frames": res["num_frames"], "txts": txts, "seconds": test_s,
                      "launches": eval_launches,
                      "car_3d_moderate_R40": res["Car_3d/moderate_R40"]}},
            train_launches, eval_launches)


def fully_sparse_phase(device, card):
    """Phase 15: VoxelNeXt (nuScenes, its double flip, the large Waymo config
    with the IoU branch) and PillarNet (KITTI, Waymo) at full width with
    seeded weights, bf16, in a temporary working directory whose cfgs/
    links to tools/cfgs/: a synthetic nuScenes root (as phase 13's) and a
    synthetic KITTI root (as phase 14's) written first, the Waymo configs
    from memory; then VoxelNeXt's nuScenes config and PillarNet's KITTI
    config from disk through tools.train and tools.test. Returns (summary,
    launches by path, served B1 entries, B2 (totals, entries) by model and
    path)."""
    import os

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as work:
        work = Path(work)
        (work / "cfgs").symlink_to(REPO / "tools" / "cfgs")
        os.chdir(work)
        try:
            t0 = time.perf_counter()
            nusc_root = work / "data" / "nuscenes"
            nusc_infos, nusc_data = nuscenes_data(nusc_root)
            kitti_root, kitti_infos = two_stage_root(work)
            data = {"nuscenes": (nusc_root, nusc_infos), "kitti": (kitti_root, kitti_infos)}
            summary = {"data_seconds": time.perf_counter() - t0, "nuscenes_data": nusc_data,
                       "card": card}
            launches, served_b1, b2 = {}, [], {}
            for name in FULLY_SPARSE_DEPTH:
                out = fully_sparse_model(name, data, device, card)
                summary[name] = out[0]
                launches.update(out[1])
                served_b1 += out[2]
                b2[name] = out[3]
            n_fwd, n_step = FULLY_SPARSE_B2["voxelnext"]
            summary["voxelnext_cli"], launches["voxelnext_cli_train"], \
                launches["voxelnext_cli_eval"] = nuscenes_cli(nusc_root, VOXELNEXT_CFG, n_step,
                                                              n_fwd, device)
            summary["pillarnet_cli"], launches["pillarnet_cli_train"], \
                launches["pillarnet_cli_eval"] = pillarnet_cli(kitti_root, device)
        finally:
            os.chdir(cwd)
    return summary, launches, served_b1, b2



# phase 16: TransFusion-L, served requests and bf16 train steps of B=4
TRANSFUSION_DEPTH = (1, 2)     # served requests, bf16 train steps
# B2 per request and per train step: VoxelResBackBone8x's 21 convs, and a
# dX for each but conv_input's (the voxel means need no gradient)
TRANSFUSION_B2 = (21, 41)
TRANSFUSION_B1 = (1, 0)        # per request (the recall: predict runs no NMS) and per step
TRANSFUSION_CFG = "cfgs/nuscenes_models/transfusion_lidar.yaml"   # from phase 16's work dir
# the regression branches, whose out weights the fp32 train check requires a gradient on
TRANSFUSION_REG = tuple(f"dense_head.{b}_out.weight" for b in ("center", "height", "dim", "rot",
                                                                "vel"))


def transfusion_serve(model, batches, device):
    """A warm-up request, the peak memory and every kernel count set to 0,
    the requests through eval_batches (bf16), the counts and the peak read.
    Fatal unless every request launched B1 once and the tensor-core B2 21
    times, or on a non-finite or misshapen output or a frame that kept no
    query. Returns (EvalResult, launches, summary)."""
    import torch

    from dfu3d_tpu_torch.train.eval_utils import eval_batches

    eval_batches(model, batches[:1], RECALL_THRESH, device=device, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res = eval_batches(model, batches, RECALL_THRESH, device=device, dtype=torch.bfloat16)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    n = len(batches)
    q = model.dense_head.num_proposals
    for k, (boxes, scores, labels, valid) in enumerate(res.preds):
        if tuple(boxes.shape) != (4, q, 9) or not torch.isfinite(boxes).all() or \
                not torch.isfinite(scores).all() or not valid.any(dim=1).all():
            fail(f"transfusion request {k}: boxes {tuple(boxes.shape)} (want (4, {q}, 9)), "
                 f"finite {bool(torch.isfinite(boxes).all())}, kept per frame "
                 f"{valid.sum(1).tolist()}")
    if launches["iou_bev_overlap"] != TRANSFUSION_B1[0] * n or \
            launches["gather_gemm_tensor_core"] != TRANSFUSION_B2[0] * n or \
            launches["gather_gemm_cuda_core"]:
        fail(f"transfusion serving: kernel launches {launches} for {n} requests, not "
             f"{TRANSFUSION_B1[0]} B1 and {TRANSFUSION_B2[0]} tensor-core B2 per request")
    ms = [s * 1e3 for s in res.batch_seconds]
    summary = {"request_ms": {"median": statistics.median(ms), "all": ms},
               "kept_per_frame": [p[3].sum(1).tolist() for p in res.preds],
               "recall": res.metric, "launches": launches,
               "launches_per_request": {k: v / n for k, v in launches.items()},
               "peak_memory_gib": peak / 2 ** 30}
    log(f"[transfusion] serving, {n} requests of B=4 (bf16): ms per request median "
        f"{summary['request_ms']['median']:.2f} (all: {', '.join(f'{v:.2f}' for v in ms)}); "
        f"peak memory {summary['peak_memory_gib']:.2f} GiB; kept per frame "
        f"{summary['kept_per_frame']}; recall {json.dumps(res.metric)}; launches per request "
        f"{json.dumps(summary['launches_per_request'])}")
    return res, launches, summary


def covering_batch(batch, grid, seed=0):
    """`batch` with its points replaced by as many drawn uniformly over the
    whole point-cloud range (x, y, z; intensity 0-255, time lag 0-0.45 s),
    so that every BEV cell's receptive field holds points. Phase 16's fp32
    request runs on it, with its own BN statistics (`calibrate_bn_`): on
    the synthetic frames, whose points end 55 m from the sensor, the
    seeded model calibrated on them compresses its heat map, and on an
    H100 the kernels and the twins picked 58 and 131 of the 800 queries
    otherwise in two runs: top-K's 200th place falls among near-ties. On
    this batch the scores spread and both pick the same queries."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    b, n, c = batch.points.shape
    lo = torch.tensor(grid.point_cloud_range[:3], dtype=torch.float32)
    hi = torch.tensor(grid.point_cloud_range[3:], dtype=torch.float32)
    pts = torch.zeros((b, n, c))
    pts[..., :3] = lo + (hi - lo) * torch.rand((b, n, 3), generator=gen)
    pts[..., 3] = 255.0 * torch.rand((b, n), generator=gen)
    pts[..., 4] = NUSC_LAG_MAX * torch.rand((b, n), generator=gen)
    return batch._replace(points=pts, points_valid=torch.ones((b, n), dtype=torch.bool))


def check_transfusion_paths(model, batch, swaps, device, replay=None):
    """One fp32 request through the kernels and through their plain twins
    (`swaps`), the BN statistics set from `batch` (the model's running
    statistics change), its gt made from queries the kernel path keeps, shifted along
    x by 0 .. 0.75 of their length: the queries' classes and cells equal,
    keep masks and labels equal, boxes and scores within PATH_TOL, recall
    counters equal and above 0. `replay` (`replayed_queries`), if given,
    holds the plain run on the kernel run's queries."""
    import torch

    from dfu3d_tpu_torch.flagship import calibrate_bn_
    from dfu3d_tpu_torch.train.train_state import make_eval_step

    calibrate_bn_(model, batch)
    pred_boxes, _, _, pred_valid = make_eval_step(model, device=device)(batch)
    gt = batch.gt_boxes.clone()
    for i in range(gt.shape[0]):
        kept = pred_boxes[i][pred_valid[i]]
        for j in range(min(16, gt.shape[1])):
            gt[i, j, :7] = kept[(7 * j) % len(kept), :7]
            gt[i, j, 0] += 0.05 * j * gt[i, j, 3]
    check_batch = batch._replace(gt_boxes=gt)
    head = model.dense_head
    queries = []
    forward = head.forward

    def recording(bev):
        out = forward(bev)
        queries.append((out["q_cls"], out["q_cell"], out["query_heatmap_score"]))
        return out

    step = make_eval_step(model, RECALL_THRESH, device=device)
    head.forward = recording
    try:
        with replay or contextlib.nullcontext():
            kb, ks, kl, kv, krec = step(check_batch)
            with plain_twins(swaps):
                pb, ps, pl, pv, prec = step(check_batch)
    finally:
        del head.forward
    (kc, kcell, kscore), (pc, pcell, pscore) = queries
    if not (torch.equal(kc, pc) and torch.equal(kcell, pcell)):
        diff = (kc != pc) | (kcell != pcell)
        fail(f"transfusion fp32 path: {int(diff.sum())} queries' class or cell differ between "
             f"kernel and plain; their heat-map scores {kscore.amax(-1)[diff][:8].tolist()}; "
             f"the last query's per frame {kscore.amax(-1)[:, -1].tolist()}")
    krec, prec = ({k: int(v) for k, v in r.items()} for r in (krec, prec))
    box_err = (kb - pb).abs()[kv].max().item()
    score_err = (ks - ps).abs().max().item()
    if not torch.equal(kv, pv) or not torch.equal(kl, pl) or not box_err <= PATH_TOL or \
            not score_err <= PATH_TOL or krec != prec or \
            not krec[f"recall_rcnn_{RECALL_THRESH[0]}"]:
        fail(f"transfusion fp32 path: keep masks equal {torch.equal(kv, pv)}, labels equal "
             f"{torch.equal(kl, pl)}, max |box diff| {box_err:.3g}, max |score diff| "
             f"{score_err:.3g} (tol {PATH_TOL}), recall {krec} vs {prec}")
    log(f"[check] transfusion fp32 whole path, kernels vs plain: {kc.numel()} queries' classes "
        f"and cells equal, keep masks and labels equal ({int(kv.sum())} kept), max |box diff| "
        f"{box_err:.3g}, max |score diff| {score_err:.3g}; recall {krec}")
    return {"queries": kc.numel(), "kept": int(kv.sum()), "max_box_diff": box_err,
            "max_score_diff": score_err, "recall": krec}


def transfusion_phase(device, card):
    """Phase 16: TransFusion-L on transfusion_lidar.yaml at its published
    widths with seeded weights, in a temporary working directory whose
    cfgs/ links to tools/cfgs/, on phase 13's synthetic nuScenes root
    (written anew): 4 bf16 requests (the first request's BN statistics,
    `calibrate_bn_`), their launches, ms, peak memory and spans, the
    served B1 and B2 calls held and timed, the fp32 request through the
    kernels and through the twins (on `covering_batch`); one bf16 step's
    B2 calls (forward and dX) held and timed, the fp32 step through the
    kernels and through the twins; 4 bf16 steps through train_model (launches, ms, peak memory,
    spans); tools.train and tools.test on the root. Returns (summary,
    launches by path, served B1 entries, B2 (totals, entries) by path)."""
    import os

    import torch

    from dfu3d_tpu_torch import profile_serve, zoo
    from dfu3d_tpu_torch.core.geometry import iou_kernel
    from dfu3d_tpu_torch.core.voxel import gather_gemm_kernel
    from dfu3d_tpu_torch.flagship import calibrate_bn_, seeded_weights_
    from dfu3d_tpu_torch.profile_serve import _run
    from dfu3d_tpu_torch.train.train_state import make_eval_step, make_train_step

    swaps = [(iou_kernel, "overlap_bev", "overlap_bev_plain"),
             (gather_gemm_kernel, "gather_gemm", "gather_gemm_plain")]
    requests, train_steps = TRANSFUSION_DEPTH
    seconds, launches, b2 = {}, {}, {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as work:
        work = Path(work)
        (work / "cfgs").symlink_to(REPO / "tools" / "cfgs")
        os.chdir(work)
        try:
            t0 = time.perf_counter()
            root = work / "data" / "nuscenes"
            infos, _ = nuscenes_data(root)
            cfg, grid, model = zoo.transfusion(device=device)
            seeded_weights_(model, seed=0)
            batches = zoo.nuscenes_batches(cfg, root, infos["val"], requests)
            calibrate_bn_(model, batches[0])
            seconds["setup_serve"] = time.perf_counter() - t0
            log(f"[transfusion] {cfg.MODEL.NAME} {'x'.join(map(str, grid.grid_size))} grid, "
                f"max_voxels {model.vfe.max_voxels}, {sum(p.numel() for p in model.parameters())} "
                f"parameters; points per request "
                f"{[b.points_valid.sum(1).tolist() for b in batches]}")

            t0 = time.perf_counter()
            res, launches["transfusion"], serve = transfusion_serve(model, batches, device)
            step = make_eval_step(model, RECALL_THRESH, device=device, dtype=torch.bfloat16)
            serve["profile"] = profile_serve.transfusion_profile(model, lambda b: _run(step, b),
                                                                 batches[:2])
            serve["profile"]["device_time"] = defer_device_profile(
                "transfusion serving", lambda: _run(step, batches[0]))
            served_b1 = time_served_overlaps("transfusion", model, batches[0], device,
                                             names=("recall",))
            calls = record_gemm_calls(lambda: step(batches[0]))
            if len(calls) != TRANSFUSION_B2[0]:
                fail(f"one transfusion eval step made {len(calls)} gather-GEMM calls, not "
                     f"{TRANSFUSION_B2[0]}")
            b2["served"] = hold_gemm_calls("transfusion, one served request",
                                           zip(GEMM_CONVS, calls))
            del calls
            serve["fp32_check"] = check_transfusion_paths(
                model, covering_batch(batches[0], grid), swaps, device)
            seconds["serve"] = time.perf_counter() - t0
            ph = serve["profile"]["phase_ms"]
            log(f"[transfusion] ({card}) instrumented request {ph['step']:.2f} ms; spans (ms) "
                + ", ".join(f"{k} {v:.2f}" for k, v in sorted(ph.items(),
                                                               key=lambda kv: -kv[1])[1:16]))
            del res, model

            t0 = time.perf_counter()
            tbatches = zoo.nuscenes_batches(cfg, root, infos["train"], train_steps,
                                            training=True)
            _, _, model = zoo.transfusion(device=device, train=True)
            seeded_weights_(model, seed=0)
            weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
            loss = []

            def bf16_forward():
                with torch.autocast("cuda", dtype=torch.bfloat16):
                    loss.append(model(tbatches[0].to(device))[0])

            fwd = record_gemm_calls(bf16_forward)
            dx = record_gemm_calls(lambda: loss[0].backward())
            model.zero_grad(set_to_none=True)
            model.load_state_dict(weights)
            check_dx_mirrors(GEMM_CONVS, fwd, dx)
            b2["dx"] = hold_gemm_calls("dX of one transfusion train step",
                                       zip(GEMM_CONVS[::-1], dx))
            del fwd, dx, loss
            check = check_train_paths("transfusion", model, tbatches[0], swaps, device,
                                      scales=True)
            reg = {k: v for k, v in check.pop("leaf_scales").items() if k in TRANSFUSION_REG}
            if len(reg) != len(TRANSFUSION_REG) or not all(v > 0 for v in reg.values()):
                fail(f"transfusion fp32 train step: a regression branch has no gradient {reg}")
            check["reg_branch_grad_max"] = reg
            del model
            torch.cuda.reset_peak_memory_stats()
            model, launches["transfusion_train"], steps, state = train(
                "transfusion", zoo.transfusion, tbatches, device)
            peak = torch.cuda.max_memory_allocated()
            bad = [s["it"] for s in steps if s["iou_bev_overlap"] != TRANSFUSION_B1[1]
                   or s["gather_gemm_tensor_core"] != TRANSFUSION_B2[1]
                   or s["gather_gemm_cuda_core"]]
            if bad:
                fail(f"transfusion train steps {bad} did not launch B1 {TRANSFUSION_B1[1]} times "
                     f"and the tensor-core B2 {TRANSFUSION_B2[1]} times: {steps}")
            tstep = make_train_step(model, state.optimizer, device=device, dtype=torch.bfloat16)

            def run_train(bt):
                return float(tstep(bt)["loss"])

            profile = profile_serve.transfusion_profile(model, run_train, tbatches[:2],
                                                        state.optimizer)
            profile["device_time"] = defer_device_profile("transfusion training",
                                                          lambda: run_train(tbatches[0]))
            seconds["train"] = time.perf_counter() - t0
            ms = [s["host_ms"] for s in steps]
            summary = {
                "config": TRANSFUSION_CFG[5:], "card": card,
                "serve": {**serve, "b1_served": [{k: e[k] for k in (
                    "problem", "shape", "ms", "plain_ms", "bound_ms", "bound_by")}
                    for e in served_b1],
                    "b2_served": {**b2["served"][0], "per_conv": compact_gemm(b2["served"][1])}},
                "train": {"batch": 4, "steps": steps,
                          "ms_per_step": {"median": statistics.median(ms), "all": ms},
                          "samples_per_s": 4 / (statistics.median(ms) / 1e3),
                          "peak_memory_gib": peak / 2 ** 30,
                          "launches": launches["transfusion_train"],
                          "b2_launches_per_step": {"forward": TRANSFUSION_B2[0],
                                                   "dx": TRANSFUSION_B2[1] - TRANSFUSION_B2[0]},
                          "b2_dx": {**b2["dx"][0], "per_conv": compact_gemm(b2["dx"][1])},
                          "fp32_check": check, "profile": profile}}
            ph = profile["phase_ms"]
            log(f"[transfusion] ({card}) training: B=4, median {statistics.median(ms):.2f} ms per "
                f"step ({summary['train']['samples_per_s']:.2f} samples/s), peak memory "
                f"{peak / 2 ** 30:.2f} GiB; host Hungarian {profile['hungarian_host_ms']:.2f} ms, "
                f"{profile['hungarian_calls_per_step']:g} per step; instrumented step "
                f"{ph['step']:.2f} ms, spans (ms) "
                + ", ".join(f"{k} {v:.2f}" for k, v in sorted(ph.items(),
                                                               key=lambda kv: -kv[1])[1:14]))
            # the train model stays for the deferred profile of its step

            t0 = time.perf_counter()
            summary["cli"], launches["transfusion_cli_train"], \
                launches["transfusion_cli_eval"] = nuscenes_cli(
                    root, TRANSFUSION_CFG, TRANSFUSION_B2[1], TRANSFUSION_B2[0], device,
                    b1_eval=TRANSFUSION_B1[0],
                    # one pass over the 8 train frames: class-balanced
                    # resampling would make the epoch ~20 steps
                    extra_sets=("DATA_CONFIG.BALANCED_RESAMPLING", "False"))
            seconds["cli"] = time.perf_counter() - t0
            summary["phase_seconds"] = seconds
        finally:
            os.chdir(cwd)
    return summary, launches, served_b1, b2


# phase 17: DSVT-Pillar and DSVT-Voxel, served requests and bf16 train steps
# of B=4 on Waymo-range frames made in memory
DSVT_DEPTH = {"dsvt_pillar": (1, 2), "dsvt_voxel": (1, 2)}
DSVT_B1 = (2, 0)   # per request (NMS, recall) and per train step
DSVT_B2 = {"dsvt_pillar": (0, 0), "dsvt_voxel": (0, 0)}   # no sparse conv on the path
# the branch whose out weights the fp32 train check requires a gradient on
DSVT_REG = ("dense_head.fused_heads.out.weight", "backbone_3d.")


def dsvt_model(name, device, card):
    """Phase 17 for one model: serving at seeded weights (launches, ms, peak
    memory, spans, set shares, the served B1 calls held and timed, the fp32
    request through the kernels and through the twins), then the fp32 step
    through the kernels and through the twins and DSVT_DEPTH's bf16 steps
    through train_model (launches, ms, peak memory, spans, set shares).
    Returns (summary, launches by path, served B1 entries)."""
    import torch

    from dfu3d_tpu_torch import profile_serve, zoo
    from dfu3d_tpu_torch.core.geometry import iou_kernel
    from dfu3d_tpu_torch.core.voxel import gather_gemm_kernel
    from dfu3d_tpu_torch.flagship import seeded_weights_
    from dfu3d_tpu_torch.profile_serve import _run
    from dfu3d_tpu_torch.train.train_state import make_eval_step, make_train_step

    build = getattr(zoo, name)
    requests, train_steps = DSVT_DEPTH[name]
    swaps = [(iou_kernel, "overlap_bev", "overlap_bev_plain"),
             (gather_gemm_kernel, "gather_gemm", "gather_gemm_plain")]
    seconds, launches = {}, {}
    t0 = time.perf_counter()
    cfg, grid, model = build(device=device)
    seeded_weights_(model, seed=0)
    batches = zoo.waymo_batches(cfg, requests, seed=0)
    seconds["setup_serve"] = time.perf_counter() - t0
    log(f"[dsvt] {name}: {type(model.backbone_3d).__name__} "
        f"{'x'.join(map(str, grid.grid_size))} grid, {model.vfe.max_voxels} voxels per frame, "
        f"MAX_SETS {model.backbone_3d.max_sets}, {sum(p.numel() for p in model.parameters())} "
        f"parameters; points per request {[b.points_valid.sum(1).tolist() for b in batches]}")

    t0 = time.perf_counter()
    res, launches[name], serve = fully_sparse_serve(name, model, batches, device, tag="dsvt")
    step = make_eval_step(model, RECALL_THRESH, device=device, dtype=torch.bfloat16)
    serve["profile"] = profile_serve.dsvt_profile(model, lambda b: _run(step, b), batches[:2])
    serve["profile"]["device_time"] = defer_device_profile(f"dsvt {name} serving",
                                                           lambda: _run(step, batches[0]))
    served_b1 = time_served_overlaps(name, model, batches[0], device)
    serve["fp32_check"] = check_paths(name, model, cfg, batches[0], res.preds[0], swaps, device)
    seconds["serve"] = time.perf_counter() - t0
    prof = serve["profile"]
    log(f"[dsvt] ({card}) {name} instrumented request {prof['phase_ms']['step']:.2f} ms; spans "
        "(ms) " + ", ".join(f"{k} {v:.2f}" for k, v in sorted(
            prof["phase_ms"].items(), key=lambda kv: -kv[1])[1:16]))
    log(f"[dsvt] {name} request 0: occupied cells per frame {prof['occupied_cells_per_frame']}, "
        f"voxels kept {prof['voxels_per_frame']}; share of each frame's voxels in a set, by "
        "layer: " + "; ".join(f"{i} {[round(v, 4) for v in row]}"
                              for i, row in enumerate(prof["set_shares"])))
    del res

    t0 = time.perf_counter()
    tbatches = zoo.waymo_batches(cfg, train_steps, seed=1)
    _, _, model = build(device=device, train=True)
    seeded_weights_(model, seed=0)
    check = check_train_paths(name, model, tbatches[0], swaps, device, scales=True)
    scales = check.pop("leaf_scales")
    reg = {k: scales[k] for k in scales if k == DSVT_REG[0]}
    trunk = max(v for k, v in scales.items() if k.startswith(DSVT_REG[1]))
    if not reg or not all(v > 0 for v in reg.values()) or not trunk > 0:
        fail(f"{name} fp32 train step: the head's out conv or the trunk has no gradient "
             f"({reg}, trunk {trunk})")
    check["reg_branch_grad_max"] = reg
    del model
    torch.cuda.reset_peak_memory_stats()
    model, launches[f"{name}_train"], steps, state = train(name, build, tbatches, device)
    peak = torch.cuda.max_memory_allocated()
    bad = [s["it"] for s in steps if s["iou_bev_overlap"] != DSVT_B1[1]
           or s["gather_gemm"] != DSVT_B2[name][1]]
    if bad:
        fail(f"{name} train steps {bad} did not launch B1 {DSVT_B1[1]} times and B2 "
             f"{DSVT_B2[name][1]} times: {steps}")
    tstep = make_train_step(model, state.optimizer, device=device, dtype=torch.bfloat16)

    def run_train(bt):
        return float(tstep(bt)["loss"])

    profile = profile_serve.dsvt_profile(model, run_train, tbatches[:2], state.optimizer)
    profile["device_time"] = defer_device_profile(f"dsvt {name} training",
                                                  lambda: run_train(tbatches[0]))
    seconds["train"] = time.perf_counter() - t0
    ms = [s["host_ms"] for s in steps]
    summary = {
        "config": f"tools/cfgs/{zoo.DSVT_CFGS[name]}", "card": card,
        "serve": {**serve, "b1_served": [{k: e[k] for k in (
            "problem", "shape", "ms", "plain_ms", "bound_ms", "bound_by")} for e in served_b1]},
        "train": {"batch": 4, "steps": steps,
                  "ms_per_step": {"median": statistics.median(ms), "all": ms},
                  "samples_per_s": 4 / (statistics.median(ms) / 1e3),
                  "peak_memory_gib": peak / 2 ** 30, "launches": launches[f"{name}_train"],
                  "fp32_check": check, "profile": profile},
        "phase_seconds": seconds}
    ph = profile["phase_ms"]
    log(f"[dsvt] ({card}) {name} training: B=4, median {statistics.median(ms):.2f} ms per step "
        f"({summary['train']['samples_per_s']:.2f} samples/s), peak memory "
        f"{peak / 2 ** 30:.2f} GiB; instrumented step {ph['step']:.2f} ms, spans (ms) "
        + ", ".join(f"{k} {v:.2f}" for k, v in sorted(ph.items(), key=lambda kv: -kv[1])[1:16]))
    # the train model stays for the deferred profile of its step
    return summary, launches, served_b1


def dsvt_phase(device, card):
    """Phase 17: DSVT-Pillar and DSVT-Voxel at full width with seeded
    weights on `zoo.waymo_batches` (the port has no Waymo dataset).
    Returns (summary, launches by path, served B1 entries)."""
    summary, launches, served_b1 = {"card": card}, {}, []
    for name in DSVT_DEPTH:
        out = dsvt_model(name, device, card)
        summary[name] = out[0]
        launches.update(out[1])
        served_b1 += out[2]
    return summary, launches, served_b1



# phase 18: MPPNet (4 and 16 frames) and MPPNetE2E, served requests and bf16
# train steps of B=2 on multi-frame Waymo-range scenes made in memory
MPPNET_DEPTH = {"mppnet_4frames": (1, 2), "mppnet_16frames": (1, 2), "mppnet_e2e": (2, 2)}
MPPNET_B2 = (12, 23)   # per request and per train step: VoxelBackBone8x, 12 forward + 11 dX
MPPNET_REG = "roi_head.jointembed."   # the joint regression: the fp32 train check needs its gradient


def mppnet_b1_names(model, bank=False, train=False):
    """The B1 calls of a request or a train step in order: the proposal NMS,
    one trajectory match per past frame, then the bank match (a request
    through the bank) and the recall, or the RoI targets' IoU."""
    traj = tuple(f"trajectory_{f}" for f in range(1, model.num_frames))
    if train:
        return ("proposal_nms", *traj, "roi_target_iou")
    return ("proposal_nms", *traj, *(("bank_match",) if bank else ()), "recall")


def mppnet_serve(name, model, batches, device):
    """A warm-up request, the peak memory and every kernel count set to 0,
    the requests served in bf16 (the E2E model through its bank from an
    empty one, with the share of its (past frame, RoI) slots that matched a
    bank entry per request), the counts and the peak read. Fatal unless
    every request launched B1 as `mppnet_b1_names` counts and the
    tensor-core B2 12 times, on a non-finite or misshapen output, or on an
    E2E sequence whose bank never matches. Returns (predictions on the host
    per request, launches, summary)."""
    import torch

    from dfu3d_tpu_torch.profile_serve import mppnet_step

    bank = hasattr(model, "predict_with_bank")
    run = mppnet_step(model, device, torch.bfloat16)
    b = batches[0].points.shape[0]

    def request(batch):   # through to its results on the host
        *out, recall = run(batch)
        return [o.cpu() for o in out] + [{k: int(v) for k, v in recall.items()}]

    run.reset(b)
    request(batches[0])
    shares, match_fn = [], getattr(model, "match_bank", None)

    def recording(traj, traj_valid, bk):
        feats, ok = match_fn(traj, traj_valid, bk)
        shares.append(ok.float().mean(dim=(0, 2)))   # per past frame
        return feats, ok

    run.reset(b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    preds, ms = [], []
    if bank:
        model.match_bank = recording
    try:
        for batch in batches:
            t0 = time.perf_counter()
            preds.append(request(batch))
            ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        if bank:
            del model.match_bank
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    n, b1 = len(batches), len(mppnet_b1_names(model, bank))
    for k, (boxes, scores, labels, valid, _) in enumerate(preds):
        if boxes.shape[:2] != (b, model.num_rois) or not torch.isfinite(boxes).all() or \
                not torch.isfinite(scores).all() or not valid.any(dim=1).all():
            fail(f"{name} request {k}: boxes {tuple(boxes.shape)}, finite "
                 f"{bool(torch.isfinite(boxes).all())}, kept per frame {valid.sum(1).tolist()}")
    if launches["iou_bev_overlap"] != b1 * n or launches["gather_gemm_tensor_core"] != \
            MPPNET_B2[0] * n or launches["gather_gemm_cuda_core"]:
        fail(f"{name} serving: kernel launches {launches} for {n} requests, not {b1} B1 and "
             f"{MPPNET_B2[0]} tensor-core B2 per request")
    shares = [sh.tolist() for sh in shares]
    if bank and not any(v > 0 for sh in shares[1:] for v in sh):
        fail(f"{name}: the bank matched no entry over {n} requests of a sequence: {shares}")
    recall = {k: sum(p[4][k] for p in preds) for k in preds[0][4]}
    summary = {"request_ms": {"median": statistics.median(ms), "all": ms},
               "kept_per_frame": [p[3].sum(1).tolist() for p in preds],
               "recall": recall, "launches": launches,
               "launches_per_request": {k: v / n for k, v in launches.items()},
               "peak_memory_gib": peak / 2 ** 30}
    if bank:
        summary["bank_matched_share_per_request"] = shares
    log(f"[mppnet] {name} serving, {n} requests of B={b} (bf16): ms per request median "
        f"{summary['request_ms']['median']:.2f} (all: {', '.join(f'{v:.2f}' for v in ms)}); "
        f"peak memory {summary['peak_memory_gib']:.2f} GiB; launches per request "
        f"{json.dumps(summary['launches_per_request'])}; recall {json.dumps(recall)}"
        + (f"; share of (past frame, RoI) slots matched in the bank per request "
           f"{[[round(v, 4) for v in sh] for sh in shares]}" if bank else ""))
    return preds, launches, summary


class replayed_proposals:
    """Within the block, the proposals (`model.proposals`) of the first run
    of `per_run` calls are recorded; each later run's own are held against
    them, call by call (valid masks equal, the kept (box, score, label)
    rows equal as sets within PATH_TOL of the recorded boxes' largest
    |entry|, at least 1; fatal otherwise), and replaced by them. MPPNet's
    head reads the points inside crop circles and balls around its boxes,
    and a box moved by the 1e-6 relative that a sum taken in another order
    moves it (through the train-mode BNs too) can take a point across an
    edge: the runs through the kernels and through the twins are held on
    the same proposals from the proposal layer on. `max_err` is the largest
    difference seen, `max_rel_err` the same over that scale."""

    def __init__(self, name, model, per_run=1):
        self.name, self.model, self.per_run = name, model, per_run
        self.recorded, self.calls, self.max_err, self.max_rel_err = [], 0, 0.0, 0.0

    def __enter__(self):
        import torch

        orig = self.model.proposals

        def replaying(*a, **k):
            out = orig(*a, **k)
            j, self.calls = self.calls, self.calls + 1
            if j < self.per_run:
                self.recorded.append(out)
                return out
            want = self.recorded[j % self.per_run]
            if not torch.equal(out[3], want[3]):
                fail(f"{self.name}: proposal valid masks differ between runs (call {j})")
            err = set_match_err(f"{self.name} proposals", out[:4], want[:4])
            scale = max(1.0, want[0][want[3]].abs().max().item() if want[3].any() else 0.0)
            self.max_err = max(self.max_err, err)
            self.max_rel_err = max(self.max_rel_err, err / scale)
            if not err <= PATH_TOL * scale:
                fail(f"{self.name}: proposals differ by {err} between runs (tol {PATH_TOL} of "
                     f"their largest |entry| {scale:.1f}, matched as sets)")
            return want

        self.model.proposals = replaying
        return self

    def __exit__(self, *exc):
        del self.model.proposals


def check_bank_paths(name, model, batches, swaps, device):
    """Requests of an E2E sequence in fp32 through the bank (from an empty
    one), through the kernels and through their plain twins (`swaps`): per
    request the valid masks and the recall counters equal and the kept
    boxes, scores and labels equal as sets within PATH_TOL; the rolled
    banks' valid masks equal and their RoIs equal as sets within
    PATH_TOL."""
    import torch

    from dfu3d_tpu_torch.profile_serve import mppnet_step

    run = mppnet_step(model, device, torch.float32)
    b = batches[0].points.shape[0]

    def roll():
        run.reset(b)
        outs = [run(batch) for batch in batches]
        torch.cuda.synchronize()
        return outs, run.bank()

    k_outs, k_bank = roll()
    with plain_twins(swaps):
        p_outs, p_bank = roll()
    errs = []
    for i, (k, p) in enumerate(zip(k_outs, p_outs)):
        if not torch.equal(k[3], p[3]):
            fail(f"{name} fp32 request {i} through the bank: valid masks differ between the "
                 f"kernels and the twins ({int((k[3] != p[3]).sum())} slots)")
        errs.append(set_match_err(f"{name} request {i}", k[:4], p[:4]))
        if {kk: int(v) for kk, v in k[4].items()} != {kk: int(v) for kk, v in p[4].items()}:
            fail(f"{name} fp32 request {i}: recall counters differ {k[4]} vs {p[4]}")
    if not torch.equal(k_bank.valid, p_bank.valid):
        fail(f"{name} fp32 bank: valid entries differ between the kernels and the twins")
    flat = [(bk.rois.flatten(0, 1), torch.zeros_like(bk.valid.flatten(0, 1), dtype=torch.float32),
             torch.zeros_like(bk.valid.flatten(0, 1), dtype=torch.int64), bk.valid.flatten(0, 1))
            for bk in (k_bank, p_bank)]
    bank_err = set_match_err(f"{name} bank", *flat)
    if not max(errs + [bank_err]) <= PATH_TOL:
        fail(f"{name} fp32 requests through the bank: kernels vs twins differ by "
             f"{max(errs)} (boxes), {bank_err} (bank RoIs), tol {PATH_TOL}")
    log(f"[check] {name} fp32 requests through the bank, kernels vs plain: valid masks equal "
        f"({[int(o[3].sum()) for o in k_outs]} boxes), kept boxes, scores and labels equal as "
        f"sets within {max(errs):.3g}; the rolled banks' valid entries equal "
        f"({int(k_bank.valid.sum())}), RoIs within {bank_err:.3g}")
    return {"requests": len(batches), "max_set_diff": max(errs), "bank_roi_diff": bank_err,
            "bank_valid_entries": int(k_bank.valid.sum())}


def mppnet_model(name, device, card):
    """Phase 18 for one model: serving at seeded weights (launches, ms, peak
    memory, spans with the dead frames' share of the head, the E2E bank's
    matches, the served B1 and B2 calls held and timed, the fp32 request or
    the E2E sequence through the kernels and through the twins), then at
    the seeded weights the train batches' gt (`zoo.proposal_gt`, made once),
    the train forward's B1 calls held and timed, the dX calls checked, held
    and timed and the fp32 step through the kernels and through the twins,
    then MPPNET_DEPTH's bf16 steps through train_model (launches, ms, peak
    memory, spans). Returns (summary, launches by path, served B1 entries,
    train B1 entries, {"served": (totals, entries), "dx": (totals, entries)})."""
    import torch

    from dfu3d_tpu_torch import profile_serve, zoo
    from dfu3d_tpu_torch.core.geometry import iou_kernel
    from dfu3d_tpu_torch.core.voxel import gather_gemm_kernel
    from dfu3d_tpu_torch.flagship import seeded_weights_
    from dfu3d_tpu_torch.train.train_state import make_train_step

    build = getattr(zoo, name)
    requests, train_steps = MPPNET_DEPTH[name]
    swaps = [(iou_kernel, "overlap_bev", "overlap_bev_plain"),
             (gather_gemm_kernel, "gather_gemm", "gather_gemm_plain")]
    seconds, launches = {}, {}
    t0 = time.perf_counter()
    cfg, grid, model = build(device=device)
    seeded_weights_(model, seed=0)
    frames, bank = model.num_frames, hasattr(model, "predict_with_bank")
    batches = zoo.waymo_sequence_batches(cfg, requests, frames, seed=0, sequence=bank)
    seconds["setup_serve"] = time.perf_counter() - t0
    log(f"[mppnet] {name}: {type(model).__name__} {'x'.join(map(str, grid.grid_size))} grid, "
        f"{model.vfe.max_voxels} voxels per frame, {frames} frames in "
        f"{model.roi_head.num_groups} groups {model.roi_head.frame_groups()}, "
        f"{sum(p.numel() for p in model.parameters())} parameters "
        f"({sum(p.numel() for p in model.roi_head.parameters())} in the head); points per "
        f"request {[b.points_valid.sum(1).tolist() for b in batches]}")

    t0 = time.perf_counter()
    preds, launches[name], serve = mppnet_serve(name, model, batches, device)
    run = profile_serve.mppnet_step(model, device, torch.bfloat16)
    run.reset(batches[0].points.shape[0])
    prof = profile_serve.mppnet_profile(model, lambda bt: profile_serve._run(run, bt),
                                        batches[:2], fresh_frames=1 if bank else None)
    prof["device_time"] = defer_device_profile(f"mppnet {name} serving",
                                               lambda: profile_serve._run(run, batches[0]))
    serve["profile"] = prof
    run.reset(batches[0].points.shape[0])
    served_b1 = time_served_overlaps(name, model, batches[0], device,
                                     mppnet_b1_names(model, bank), step=run)
    calls = record_gemm_calls(lambda: run(batches[0]))
    if len(calls) != len(VOXEL8X_CONVS):
        fail(f"one {name} request made {len(calls)} gather-GEMM calls, not {len(VOXEL8X_CONVS)}")
    served_b2 = hold_gemm_calls(f"{name}, one served request", zip(VOXEL8X_CONVS, calls))
    del calls
    with replayed_proposals(name, model, per_run=2 if bank else 1) as replay:
        serve["fp32_check"] = (check_bank_paths(name, model, batches[:2], swaps, device) if bank
                               else check_paths(name, model, cfg, batches[0], preds[0][:4],
                                                swaps, device))
    serve["fp32_check"].update(proposals_max_set_diff=replay.max_err,
                               proposals_max_rel_diff=replay.max_rel_err)
    seconds["serve"] = time.perf_counter() - t0
    ph = prof["phase_ms"]
    log(f"[mppnet] ({card}) {name} instrumented request {ph['step']:.2f} ms; spans (ms) "
        + ", ".join(f"{k} {v:.2f}" for k, v in sorted(ph.items(), key=lambda kv: -kv[1])[1:18])
        + f"; head {prof['head_ms']:.2f} ms, frames feeding no group {prof['dead_frames']}, "
          f"their share of the head {prof['dead_frame_share_of_head']:.3f}")

    t0 = time.perf_counter()
    b = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    tbatches = zoo.waymo_sequence_batches(cfg, train_steps, frames, seed=1)
    _, _, model = build(device=device, train=True)
    seeded_weights_(model, seed=0)
    reset_launches()
    gt_batches = [zoo.proposal_gt(model, bt, torch.bfloat16) for bt in tbatches]
    launches[f"{name}_gt"] = read_launches()
    train_b1 = train_overlaps(name, model, gt_batches[0], device, coord_tol=True,
                              names=mppnet_b1_names(model, train=True))
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
    check_dx_mirrors(VOXEL8X_CONVS, fwd, dx)
    train_dx = hold_gemm_calls(f"dX of one {name} train step", zip(VOXEL8X_CONVS[::-1], dx))
    del loss, fwd, dx
    with replayed_proposals(name, model) as replay:
        check = check_two_stage_train_paths(name, model, tbatches[0], device,
                                            reg_prefix=MPPNET_REG)
    check.update(proposals_max_set_diff=replay.max_err,
                 proposals_max_rel_diff=replay.max_rel_err)
    del model
    torch.cuda.reset_peak_memory_stats()
    model, launches[f"{name}_train"], steps, state = train(name, build, gt_batches, device)
    peak = torch.cuda.max_memory_allocated()
    b1_step = len(mppnet_b1_names(model, train=True))
    bad = [s["it"] for s in steps if s["iou_bev_overlap"] != b1_step
           or s["gather_gemm_tensor_core"] != MPPNET_B2[1] or s["gather_gemm_cuda_core"]]
    fg_steps = [s["it"] for s in steps if s["rcnn_reg_loss"] > 0]
    if bad or steps[0]["it"] not in fg_steps:
        fail(f"{name} train steps {bad} did not launch B1 {b1_step} times and the tensor-core "
             f"B2 {MPPNET_B2[1]} times, or the first step had no RoI over REG_FG_THRESH "
             f"(steps with one: {fg_steps})")
    tstep = make_train_step(model, state.optimizer, device=device, dtype=torch.bfloat16)

    def run_train(bt):
        return float(tstep(bt)["loss"])

    profile = profile_serve.mppnet_profile(model, run_train, gt_batches[:2], state.optimizer)
    profile["device_time"] = defer_device_profile(f"mppnet {name} training",
                                                  lambda: run_train(gt_batches[0]))
    seconds["train"] = time.perf_counter() - t0
    ms = [s["host_ms"] for s in steps]
    summary = {
        "config": f"tools/cfgs/{zoo.MPPNET_CFGS[name]}", "card": card, "frames": frames,
        "serve": {**serve, "b1_served": [{k: e[k] for k in (
            "problem", "shape", "ms", "plain_ms", "bound_ms", "bound_by", "survivor_share",
            "overlapping_share")} for e in served_b1],
                  "b2_served": {**served_b2[0], "per_conv": compact_gemm(served_b2[1])}},
        "train": {"batch": b, "steps": steps,
                  "ms_per_step": {"median": statistics.median(ms), "all": ms},
                  "samples_per_s": b / (statistics.median(ms) / 1e3),
                  "peak_memory_gib": peak / 2 ** 30, "launches": launches[f"{name}_train"],
                  "gt_launches": launches[f"{name}_gt"], "steps_with_fg_rois": fg_steps,
                  "b1_train": train_b1,
                  "b2_dx": {**train_dx[0], "per_conv": compact_gemm(train_dx[1])},
                  "fp32_check": check, "profile": profile},
        "phase_seconds": seconds}
    ph = profile["phase_ms"]
    log(f"[mppnet] ({card}) {name} training: B={b}, median {statistics.median(ms):.2f} ms per "
        f"step ({summary['train']['samples_per_s']:.2f} samples/s), peak memory "
        f"{peak / 2 ** 30:.2f} GiB; instrumented step {ph['step']:.2f} ms, spans (ms) "
        + ", ".join(f"{k} {v:.2f}" for k, v in sorted(ph.items(), key=lambda kv: -kv[1])[1:18])
        + f"; dead frames' share of the head {profile['dead_frame_share_of_head']:.3f}; seconds "
          f"{json.dumps({k: round(v, 2) for k, v in seconds.items()})}")
    # the train model stays for the deferred profile of its step
    return summary, launches, served_b1, train_b1, {"served": served_b2, "dx": train_dx}


def mppnet_phase(device, card):
    """Phase 18: MPPNet on mppnet_4frames.yaml and mppnet_16frames.yaml and
    MPPNetE2E on mppnet_e2e_memorybank_inference.yaml at full width with
    seeded weights on `zoo.waymo_sequence_batches` (the port has no Waymo
    dataset). Returns (summary, launches by path, served B1 entries, train
    B1 entries, B2 totals and entries by model)."""
    summary, launches, served_b1, train_b1, b2 = {"card": card}, {}, [], [], {}
    for name in MPPNET_DEPTH:
        out = mppnet_model(name, device, card)
        summary[name] = out[0]
        launches.update(out[1])
        served_b1 += out[2]
        train_b1 += out[3]
        b2[name] = out[4]
    return summary, launches, served_b1, train_b1, b2


# phase 19: the camera detectors (BEVFusion, CaDDN, the focal multimodal Voxel
# R-CNN), served requests and bf16 train steps of B=4 on `zoo.camera_batches`
CAMERA_DEPTH = (2, 2)   # served requests, bf16 train steps, per model
CAMERA_MODELS = ("bevfusion", "caddn", "voxel_rcnn_focal")
# B1 per request (NMS, recall; BEVFusion runs no NMS) and per train step
CAMERA_B1 = {"bevfusion": (1, 0), "caddn": (2, 0), "voxel_rcnn_focal": (3, 2)}
# B2 per request and per train step: BEVFusion's VoxelResBackBone8x as
# TransFusion's; the focal trunk's 18 convs (focal1-3 each an importance and
# a main conv) and a dX for each but conv_input's
CAMERA_B2 = {"bevfusion": (21, 41), "caddn": (0, 0), "voxel_rcnn_focal": (18, 35)}
CAMERA_B1_NAMES = {"bevfusion": ("recall",), "caddn": ("nms", "recall"),
                   "voxel_rcnn_focal": POINTRCNN_OVERLAPS}
FOCAL_CONVS = ["conv_input", "conv1", "focal1.conv_imp", "focal1.conv", "down2", "conv2a",
               "conv2b", "focal2.conv_imp", "focal2.conv", "down3", "conv3a", "conv3b",
               "focal3.conv_imp", "focal3.conv", "down4", "conv4a", "conv4b", "conv_out"]
CAMERA_CONVS = {"bevfusion": GEMM_CONVS, "voxel_rcnn_focal": FOCAL_CONVS}
CAMERA_REG = {"bevfusion": TRANSFUSION_REG, "caddn": ("dense_head.conv_box.",),
              "voxel_rcnn_focal": ("reg_fc.", "reg_pred.")}


def camera_serve(name, model, batches, device):
    """A warm-up request, the peak memory and every kernel count set to 0,
    the requests through eval_batches (bf16), the counts and the peak read.
    Fatal unless every request launched B1 and B2 as CAMERA_B1 / CAMERA_B2
    count, or on a non-finite output. Returns (EvalResult, launches,
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
    n = len(batches)
    for k, (boxes, scores, labels, valid) in enumerate(res.preds):
        if not torch.isfinite(boxes).all() or not torch.isfinite(scores).all():
            fail(f"{name} request {k}: boxes or scores not finite")
    b1, b2 = CAMERA_B1[name][0], CAMERA_B2[name][0]
    if launches["iou_bev_overlap"] != b1 * n or launches["gather_gemm"] != b2 * n:
        fail(f"{name} serving: kernel launches {launches} for {n} requests, not {b1} B1 and "
             f"{b2} B2 per request")
    ms = [s * 1e3 for s in res.batch_seconds]
    summary = {"request_ms": {"median": statistics.median(ms), "all": ms},
               "kept_per_frame": [p[3].sum(1).tolist() for p in res.preds],
               "recall": res.metric, "launches": launches,
               "launches_per_request": {k: v / n for k, v in launches.items()},
               "peak_memory_gib": peak / 2 ** 30}
    log(f"[camera] {name} serving, {n} requests of B=4 (bf16): ms per request median "
        f"{summary['request_ms']['median']:.2f} (all: {', '.join(f'{v:.2f}' for v in ms)}); "
        f"peak memory {summary['peak_memory_gib']:.2f} GiB; kept per frame "
        f"{summary['kept_per_frame']}; recall {json.dumps(res.metric)}; launches per request "
        f"{json.dumps(summary['launches_per_request'])}")
    return res, launches, summary


class deterministic:
    """Within the block, PyTorch's deterministic algorithms (warnings only
    where an op has none), cuDNN's, and scaled_dot_product_attention on its
    math backend (the memory-efficient backward is not deterministic):
    BEVFusion's fp32 checks compare gradients of the camera branch, which no
    kernel touches, and the ones of its first dtransform conv (1 channel of
    mostly empty depth maps, then a train-mode BN) moved by 0.1-0.5 of their
    largest entry between two runs of the same step with the default
    algorithms and bev_pool's atomic adds."""

    def __enter__(self):
        import torch
        from torch.nn.attention import SDPBackend, sdpa_kernel

        self.saved = (torch.are_deterministic_algorithms_enabled(),
                      torch.is_deterministic_algorithms_warn_only_enabled(),
                      torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        self.sdpa = sdpa_kernel([SDPBackend.MATH])
        self.sdpa.__enter__()

    def __exit__(self, *exc):
        import torch

        self.sdpa.__exit__(*exc)
        mode, warn, det, bench = self.saved
        torch.use_deterministic_algorithms(mode, warn_only=warn)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det, bench


QUERY_TIE_TOL = 1e-5   # heat-map score, of a query the two runs may pick apart


class replayed_queries:
    """Within the block, the top-K selection of a head that makes one per
    run (`head_module.top_k`: by default the TransFusion head's top-Q
    queries, or a single CenterHead's top-K peaks) of the first run is
    recorded and each later run's is held against it and replaced by it:
    the picks a later run makes apart must score within QUERY_TIE_TOL of
    the recorded run's K-th (fatal otherwise). BEVFusion's calibrated heat
    map crowds its top 800 scores within 2e-3 (0.7486-0.7507 on the first
    card run), and the twin's other summation order swapped two queries
    3e-7 apart at the cut; the fp32 request check then compares the same
    queries' boxes and scores. `swapped` counts the picks replaced. With
    `per_run` > 1 a run makes that many selections (a CenterHead's per
    head), and each later run's i-th is held against the first run's i-th."""

    def __init__(self, head_module=None, per_run=1):
        self.recorded, self.swapped = [], 0
        self.head_module = head_module
        self.per_run, self.calls = per_run, 0

    def __enter__(self):
        import torch

        from dfu3d_tpu_torch.models import transfusion_head

        th = self.head_module = self.head_module or transfusion_head
        self.orig = th.top_k

        def replaying(x, k):
            vals, idx = self.orig(x, k)
            i, self.calls = self.calls % self.per_run, self.calls + 1
            if len(self.recorded) < self.per_run:
                self.recorded.append((vals[:, -1:].clone(), idx.clone()))
                return vals, idx
            cut, want = self.recorded[i]
            apart = ~(idx[:, :, None] == want[:, None, :]).any(-1)
            near = (vals - cut).abs() <= QUERY_TIE_TOL
            if not near[apart].all():
                fail(f"replayed queries: a query picked apart scores "
                     f"{vals[apart & ~near][:4].tolist()} against the cut {cut.flatten().tolist()}")
            self.swapped += int(apart.sum())
            return torch.gather(x, 1, want), want

        th.top_k = replaying
        return self

    def __exit__(self, *exc):
        self.head_module.top_k = self.orig


def camera_model(name, device, card):
    """Phase 19 for one model at full width with seeded weights and the BN
    statistics of the first request (`calibrate_bn_`): CAMERA_DEPTH's bf16
    requests (launches, ms, peak memory, spans), the served B1 and B2 calls
    held against their twins and timed, the fp32 request through the
    kernels and through the twins; one bf16 step's B2 calls (forward and
    dX) held and timed, the fp32 step through the kernels and through the
    twins; CAMERA_DEPTH's bf16 steps through train_model (launches, ms,
    peak memory, spans). The focal model's train batches carry
    `zoo.proposal_gt`'s gt (made once, from the seeded model) and its fp32
    checks hold both runs on the same proposals. Returns (summary,
    launches by path, served B1 entries, B2 (totals, entries) by path)."""
    import torch

    from dfu3d_tpu_torch import profile_serve, zoo
    from dfu3d_tpu_torch.core.geometry import iou_kernel
    from dfu3d_tpu_torch.core.voxel import gather_gemm_kernel
    from dfu3d_tpu_torch.flagship import calibrate_bn_, seeded_weights_
    from dfu3d_tpu_torch.profile_serve import _run
    from dfu3d_tpu_torch.train.train_state import make_eval_step, make_train_step

    swaps = [(iou_kernel, "overlap_bev", "overlap_bev_plain"),
             (gather_gemm_kernel, "gather_gemm", "gather_gemm_plain")]
    build = getattr(zoo, name)
    requests, train_steps = CAMERA_DEPTH
    seconds, launches, b2 = {}, {}, {}
    t0 = time.perf_counter()
    cfg, grid, model = build(device=device)
    seeded_weights_(model, seed=0)
    batches, data = profile_serve.camera_workload(name, cfg, requests)
    calibrate_bn_(model, batches[0])
    seconds["setup_serve"] = time.perf_counter() - t0
    log(f"[camera] {name}: {cfg.MODEL.NAME} {'x'.join(map(str, grid.grid_size))} grid, "
        f"{sum(p.numel() for p in model.parameters())} parameters; {data}")

    t0 = time.perf_counter()
    res, launches[name], serve = camera_serve(name, model, batches, device)
    step = make_eval_step(model, RECALL_THRESH, device=device, dtype=torch.bfloat16)
    serve["profile"] = profile_serve.camera_profile(model, lambda b: _run(step, b), batches[:1])
    serve["profile"]["device_time"] = defer_device_profile(f"camera {name} serving",
                                                           lambda: _run(step, batches[0]))
    served_b1 = time_served_overlaps(name, model, batches[0], device, CAMERA_B1_NAMES[name])
    if name in CAMERA_CONVS:
        calls = record_gemm_calls(lambda: step(batches[0]))
        if len(calls) != CAMERA_B2[name][0]:
            fail(f"one {name} request made {len(calls)} gather-GEMM calls, not "
                 f"{CAMERA_B2[name][0]}")
        b2["served"] = hold_gemm_calls(f"{name}, one served request",
                                       zip(CAMERA_CONVS[name], calls))
        del calls
    if name == "bevfusion":
        replay = replayed_queries()
        with deterministic():
            serve["fp32_check"] = check_transfusion_paths(
                model, covering_batch(batches[0], grid), swaps, device, replay)
        serve["fp32_check"]["queries_replayed"] = replay.swapped
    else:
        with replayed_proposals(name, model) if name == "voxel_rcnn_focal" else \
                contextlib.nullcontext() as replay:
            serve["fp32_check"] = check_paths(name, model, cfg, batches[0], res.preds[0][:4],
                                              swaps, device)
        if replay is not None:
            serve["fp32_check"].update(proposals_max_set_diff=replay.max_err,
                                       proposals_max_rel_diff=replay.max_rel_err)
    seconds["serve"] = time.perf_counter() - t0
    ph = serve["profile"]["phase_ms"]
    log(f"[camera] ({card}) {name} instrumented request {ph['step']:.2f} ms; spans (ms) "
        + ", ".join(f"{k} {v:.2f}" for k, v in sorted(ph.items(), key=lambda kv: -kv[1])[1:18])
        + (f"; focal dilation {json.dumps(serve['profile']['focal_dilation'])}"
           if "focal_dilation" in serve["profile"] else ""))
    del res

    t0 = time.perf_counter()
    tbatches, _ = profile_serve.camera_workload(name, cfg, train_steps, training=True)
    _, _, model = build(device=device, train=True)
    seeded_weights_(model, seed=0)
    if name == "voxel_rcnn_focal":
        tbatches = [zoo.proposal_gt(model, bt, torch.bfloat16) for bt in tbatches]
    if name in CAMERA_CONVS:
        weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
        loss = []

        def bf16_forward():
            with torch.autocast("cuda", dtype=torch.bfloat16):
                loss.append(model(tbatches[0].to(device))[0])

        fwd = record_gemm_calls(bf16_forward)
        dx = record_gemm_calls(lambda: loss[0].backward())
        model.zero_grad(set_to_none=True)
        model.load_state_dict(weights)
        check_dx_mirrors(CAMERA_CONVS[name], fwd, dx)
        b2["dx"] = hold_gemm_calls(f"dX of one {name} train step",
                                   zip(CAMERA_CONVS[name][::-1], dx))
        del fwd, dx, loss
    if name == "voxel_rcnn_focal":
        with replayed_proposals(name, model) as replay:
            check = check_two_stage_train_paths(name, model, tbatches[0], device,
                                                reg_prefix=CAMERA_REG[name])
        check.update(proposals_max_set_diff=replay.max_err,
                     proposals_max_rel_diff=replay.max_rel_err)
    else:
        with deterministic():
            check = check_train_paths(name, model, tbatches[0], swaps, device, scales=True)
        reg = {k: v for k, v in check.pop("leaf_scales").items()
               if k.startswith(CAMERA_REG[name])}
        if not reg or not all(v > 0 for v in reg.values()):
            fail(f"{name} fp32 train step: a regression leaf has no gradient {reg}")
        check["reg_branch_grad_max"] = reg
    del model
    torch.cuda.reset_peak_memory_stats()
    model, launches[f"{name}_train"], steps, state = train(name, build, tbatches, device)
    peak = torch.cuda.max_memory_allocated()
    bad = [s["it"] for s in steps if s["iou_bev_overlap"] != CAMERA_B1[name][1]
           or s["gather_gemm"] != CAMERA_B2[name][1]]
    if bad:
        fail(f"{name} train steps {bad} did not launch B1 {CAMERA_B1[name][1]} times and B2 "
             f"{CAMERA_B2[name][1]} times: {steps}")
    tstep = make_train_step(model, state.optimizer, device=device, dtype=torch.bfloat16)

    def run_train(bt):
        return float(tstep(bt)["loss"])

    profile = profile_serve.camera_profile(model, run_train, tbatches[:1], state.optimizer)
    profile["device_time"] = defer_device_profile(f"camera {name} training",
                                                  lambda: run_train(tbatches[0]))
    seconds["train"] = time.perf_counter() - t0
    ms = [s["host_ms"] for s in steps]
    summary = {
        "config": f"tools/cfgs/{zoo.CAMERA_CFGS[name]}", "card": card,
        "serve": {**serve, "b1_served": [{k: e[k] for k in (
            "problem", "shape", "ms", "plain_ms", "bound_ms", "bound_by")} for e in served_b1]},
        "train": {"batch": 4, "steps": steps,
                  "ms_per_step": {"median": statistics.median(ms), "all": ms},
                  "samples_per_s": 4 / (statistics.median(ms) / 1e3),
                  "peak_memory_gib": peak / 2 ** 30, "launches": launches[f"{name}_train"],
                  "fp32_check": check, "profile": profile},
        "phase_seconds": seconds}
    for path, (totals, entries) in b2.items():
        summary["serve" if path == "served" else "train"][f"b2_{path}"] = {
            **totals, "per_conv": compact_gemm(entries)}
    ph = profile["phase_ms"]
    log(f"[camera] ({card}) {name} training: B=4, median {statistics.median(ms):.2f} ms per "
        f"step ({summary['train']['samples_per_s']:.2f} samples/s), peak memory "
        f"{peak / 2 ** 30:.2f} GiB; instrumented step {ph['step']:.2f} ms, spans (ms) "
        + ", ".join(f"{k} {v:.2f}" for k, v in sorted(ph.items(), key=lambda kv: -kv[1])[1:16])
        + f"; seconds {json.dumps({k: round(v, 2) for k, v in seconds.items()})}")
    # the train model stays for the deferred profile of its step
    return summary, launches, served_b1, b2


def camera_phase(device, card):
    """Phase 19: BEVFusion on bevfusion.yaml, CaDDN on CaDDN.yaml and the
    focal Voxel R-CNN on voxel_rcnn_focal.yaml at their published widths
    (`camera_model`), then one bf16 request of
    voxel_rcnn_car_focal_multimodal.yaml (B1 3 and B2 18 launches). The
    camera models run from memory only (`zoo.camera_batches`): neither
    package loads images from disk. Returns (summary, launches by path,
    served B1 entries, B2 (totals, entries) by model and path)."""
    import torch

    from dfu3d_tpu_torch import profile_serve, zoo
    from dfu3d_tpu_torch.flagship import calibrate_bn_, seeded_weights_

    t0 = time.perf_counter()
    summary, launches, served_b1, b2 = {"card": card}, {}, [], {}
    for name in CAMERA_MODELS:
        out = camera_model(name, device, card)
        summary[name] = out[0]
        launches.update(out[1])
        served_b1 += out[2]
        b2[name] = out[3]
    cfg, _, model = zoo.voxel_rcnn_focal_car(device=device)
    seeded_weights_(model, seed=0)
    batches, _ = profile_serve.camera_workload("voxel_rcnn_focal", cfg, 1)
    calibrate_bn_(model, batches[0])
    res, launches["voxel_rcnn_focal_car"], serve = camera_serve("voxel_rcnn_focal", model,
                                                                batches, device)
    summary["voxel_rcnn_focal_car"] = {"config": f"tools/cfgs/{zoo.CAMERA_CFGS['voxel_rcnn_focal_car']}",
                                       "serve": serve}
    del model, res
    torch.cuda.empty_cache()
    summary["phase_seconds"] = time.perf_counter() - t0
    log(f"[camera] ({card}) phase 19 in {summary['phase_seconds']:.1f} s")
    return summary, launches, served_b1, b2


# phase 20: the other lidar datasets from disk through the CLIs, at full width
WAYMO_CLI_CFG = "cfgs/waymo_models/centerpoint.yaml"   # from phase 20's work dir
ONCE_CLI_CFG = "cfgs/once_models/centerpoint.yaml"
DATASET_TEST_CFGS = {"lyft": "cfgs/lyft_models/cbgs_second_multihead.yaml",
                     "custom": "cfgs/custom_models/second.yaml",
                     "argo2": "cfgs/argo2_models/cbgs_voxel01_voxelnext.yaml"}
# frames per train and val sequence: 2 x 20 give 8 train frames at the
# shipped SAMPLED_INTERVAL of 5 (two steps of B=4), 4 val frames one request
WAYMO_SEQS = ([20, 20], [4])
WAYMO_POINTS = 150_000          # a full-width Waymo frame, 5 % of it in no-label zones
ONCE_FRAMES, ONCE_POINTS = (8, 4), 60_000
DATASET_TEST_FRAMES = 4         # Lyft, Custom, Argo2: one request of B=4
DATASET_POINTS = {"custom": 60_000, "argo2": 100_000}   # Lyft: 5 sweeps of 34,000
# B2 launches per request and per bf16 train step: VoxelResBackBone8x 21 and
# 41 (Waymo and ONCE CenterPoint), VoxelBackBone8x 12 (Lyft's and Custom's
# SECOND), VoxelNeXt's trunk, conv_out, shared conv and its 5 heads x 6
# branches on Argo2 (62: six fewer than nuScenes' 6 heads)
DATASETS_B2 = {"waymo": (21, 41), "once": (21, 41), "lyft": (12, None),
               "custom": (12, None), "argo2": (62, None)}
DATASETS_B1 = 2                 # per eval step (NMS, recall); none in a train step
ONCE_TEST_INFOS = "once_infos_val.pkl"   # the test mode reads INFO_PATH['test'] (ROADMAP Queue C)


def datasets_cli(tag, cfg_file, root, device, ckpt=None, sets=(), frames=DATASET_TEST_FRAMES):
    """tools.train for 1 epoch (bf16, the config's batch) unless `ckpt` is
    given, then tools.test of the checkpoint on the val split; the kernel
    counts set to 0 before each and read after. Fatal on a non-finite loss,
    no checkpoint, a train step that does not launch the tensor-core B2
    DATASETS_B2 times and no B1, an eval batch that does not launch B1
    DATASETS_B1 and B2 DATASETS_B2 times, or results for other than
    `frames` frames. Returns (summary, result, train launches, eval
    launches)."""
    from dfu3d_tpu_torch.tools import test as test_cli, train as train_cli

    b2_request, b2_step = DATASETS_B2[tag]
    common = ["--cfg_file", cfg_file, "--device", device.type, "--workers", str(LOADER_WORKERS),
              "--extra_tag", "chip_smoke"]
    sets = ["--set", "DATA_CONFIG.DATA_PATH", str(root), *sets]
    summary, train_launches = {}, None
    if ckpt is None:
        reset_launches()
        t0 = time.perf_counter()
        trained = train_cli.main([*common, "--epochs", "1", *sets])
        summary["train_s"] = time.perf_counter() - t0
        train_launches = read_launches()
        (epoch,) = trained["epochs"]
        ckpt = trained["ckpt_dir"] / "checkpoint_epoch_1.pth"
        steps = epoch["steps"]
        if not steps or not all(math.isfinite(v) for v in epoch["losses"]) or \
                not ckpt.exists() or train_launches["iou_bev_overlap"] or \
                train_launches["gather_gemm_tensor_core"] != b2_step * steps or \
                train_launches["gather_gemm_cuda_core"]:
            fail(f"tools.train {cfg_file}: {epoch}, checkpoint {ckpt.exists()}, kernel "
                 f"launches {train_launches} (want {b2_step} tensor-core B2 per step, no B1)")
        summary.update(train_steps=steps, train_losses=epoch["losses"],
                       train_launches=train_launches,
                       train_ms_per_step=(epoch["batch_time"] - epoch["data_time"]) * 1e3 / steps,
                       train_data_s=epoch["data_time"])
    reset_launches()
    t0 = time.perf_counter()
    ((_, _, result),) = test_cli.main([*common, "--ckpt", str(ckpt), *sets])
    summary["test_s"] = time.perf_counter() - t0
    eval_launches = read_launches()
    batches = result["eval_batches"]
    if result["num_frames"] != frames or \
            eval_launches["iou_bev_overlap"] != DATASETS_B1 * batches or \
            eval_launches["gather_gemm"] != b2_request * batches or \
            eval_launches["gather_gemm_cuda_core"]:
        fail(f"tools.test {cfg_file}: {result['num_frames']} frames of {frames}, {batches} "
             f"batches, kernel launches {eval_launches} (want {DATASETS_B1} B1 and "
             f"{b2_request} tensor-core B2 per batch)")
    summary.update(eval_batches=batches, eval_frames=result["num_frames"],
                   eval_launches=eval_launches, gt_num=result["gt_num"],
                   eval_ms_per_request=result["time/eval_steps"] * 1e3 / batches,
                   time_split_s={k: result[k] for k in result if k.startswith("time/")})
    return summary, result, train_launches, eval_launches


def dataset_model(cfg_file, root, device):
    """The model of a phase 20 config as the CLIs build it (`tools.common.
    build_model`, test mode) at seeded weights, with the BN statistics of
    the first test batch read from `root` (`flagship.calibrate_bn_`);
    returns (cfg, model, that batch, the test dataset)."""
    from dfu3d_tpu_torch.data.loader import build_dataloader
    from dfu3d_tpu_torch.flagship import calibrate_bn_, seeded_weights_
    from dfu3d_tpu_torch.tools.common import build_model
    from dfu3d_tpu_torch.utils.config import CfgDict, cfg_from_yaml_file

    cfg = cfg_from_yaml_file(cfg_file, CfgDict())
    cfg.DATA_CONFIG.DATA_PATH = str(root)
    dataset, loader = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                       batch_size=cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU,
                                       workers=LOADER_WORKERS, training=False)
    batch, _ = next(iter(loader))
    model = build_model(cfg, "test", device)
    seeded_weights_(model, seed=0)
    calibrate_bn_(model, batch)
    return cfg, model, batch, dataset


def frame_points(ds, cap):
    """Points of the first test-mode frame of `ds` (NLZ and range filters
    applied) and what the collate's cap keeps of them."""
    import numpy as np

    np.random.seed(0)
    n = len(ds[0]["points"])
    return n, min(n, cap)


def waymo_data(work):
    """Phase 20's Waymo root (`lidar_synthetic.write_waymo_root`, the config's
    PROCESSED_DATA_TAG) and the dataset's view of it; fatal unless the train
    mode reads 8 frames at SAMPLED_INTERVAL 5 and a test frame keeps its 5
    columns (elongation)."""
    from dfu3d_tpu_torch.data import lidar_synthetic
    from dfu3d_tpu_torch.data.waymo_dataset import WaymoDataset
    from dfu3d_tpu_torch.utils.config import CfgDict, cfg_from_yaml_file

    cfg = cfg_from_yaml_file(WAYMO_CLI_CFG, CfgDict())
    root = work / "data" / "waymo"
    t0 = time.perf_counter()
    seqs = lidar_synthetic.write_waymo_root(root, *WAYMO_SEQS, cfg.DATA_CONFIG.POINT_CLOUD_RANGE,
                                            num_points=WAYMO_POINTS, seed=20,
                                            tag=cfg.DATA_CONFIG.PROCESSED_DATA_TAG)
    write_s = time.perf_counter() - t0
    train = WaymoDataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, training=True, root_path=root)
    test = WaymoDataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, training=False, root_path=root)
    t0 = time.perf_counter()
    n, kept = frame_points(test, test.max_points_per_frame)
    get_ms = (time.perf_counter() - t0) * 1e3
    width = test[0]["points"].shape[1]
    want_train = sum(len(range(0, f, cfg.DATA_CONFIG.SAMPLED_INTERVAL["train"]))
                     for f in WAYMO_SEQS[0])
    if len(train) != want_train or len(test) != sum(WAYMO_SEQS[1]) or width != 5:
        fail(f"Waymo root: {len(train)} train frames (want {want_train}), {len(test)} val, "
             f"{width} point columns (want 5, with elongation)")
    out = {"sequences": seqs, "write_s": write_s, "train_frames": len(train),
           "val_frames": len(test), "points_per_frame": WAYMO_POINTS,
           "points_after_nlz_and_range": n, "points_kept_by_cap": kept,
           "cap": test.max_points_per_frame, "getitem_ms": get_ms}
    log(f"[datasets] Waymo root: {sum(WAYMO_SEQS[0])} train frames in {len(WAYMO_SEQS[0])} "
        f"sequences ({len(train)} at SAMPLED_INTERVAL {cfg.DATA_CONFIG.SAMPLED_INTERVAL['train']}"
        f") + {len(test)} val, {WAYMO_POINTS} points x 6 columns each, written in "
        f"{write_s:.2f} s; one test-mode frame {get_ms:.1f} ms: {n} points after the NLZ and "
        f"range filters, {kept} kept by MAX_POINTS_PER_FRAME {test.max_points_per_frame}")
    return root, out


def waymo_request_check(root, device, card):
    """One bf16 request of Waymo CenterPoint on the first val batch from disk
    at seeded weights with that batch's BN statistics: its launches (B1 2,
    the tensor-core B2 21) and ms; its 21 B2 calls and 2 B1 calls held
    against the plain twins and timed; the fp32 request through the kernels
    and through the twins (`check_paths`) on the same top-500 heat-map
    peaks (`replayed_queries`). At identity BN the seeded trunk's
    activations grow through its 16 residual blocks and the two summation
    orders put boxes 0.8-1.1e-4 m apart at Waymo's 75 m range; with the
    statistics they agree to the rounding, but the compressed heat map
    puts near-ties at the 500th peak, which the two orders break apart."""
    import torch

    from dfu3d_tpu_torch.core.geometry import iou_kernel
    from dfu3d_tpu_torch.core.voxel import gather_gemm_kernel
    from dfu3d_tpu_torch.models import center_head
    from dfu3d_tpu_torch.train.eval_utils import eval_batches

    cfg, model, batch, _ = dataset_model(WAYMO_CLI_CFG, root, device)
    eval_batches(model, [batch], RECALL_THRESH, device=device, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    reset_launches()
    res = eval_batches(model, [batch], RECALL_THRESH, device=device, dtype=torch.bfloat16)
    launches = read_launches()
    if launches["iou_bev_overlap"] != DATASETS_B1 or launches["gather_gemm_tensor_core"] != 21 \
            or launches["gather_gemm_cuda_core"]:
        fail(f"Waymo CenterPoint request from disk: launches {launches}, not 2 B1 and 21 "
             f"tensor-core B2")
    boxes, scores, _, valid = res.preds[0]
    if not torch.isfinite(boxes[valid]).all() or not valid.any(dim=1).all():
        fail(f"Waymo CenterPoint request from disk: kept per frame {valid.sum(1).tolist()}")
    served_b1 = time_served_overlaps("waymo_centerpoint", model, batch, device)
    served_b2 = time_served_gemms(model, batch, device)
    with replayed_queries(center_head) as replay:
        check = check_paths("waymo_centerpoint", model, cfg, batch, res.preds[0],
                            [(iou_kernel, "overlap_bev", "overlap_bev_plain"),
                             (gather_gemm_kernel, "gather_gemm", "gather_gemm_plain")], device)
    check["peaks_replayed"] = replay.swapped
    ms = res.batch_seconds[0] * 1e3
    log(f"[datasets] ({card}) Waymo CenterPoint, one bf16 request of B=4 from disk at seeded "
        f"weights: {ms:.2f} ms, kept per frame {valid.sum(1).tolist()}, launches "
        f"{json.dumps(launches)}")
    return {"request_ms": ms, "launches": launches, "kept_per_frame": valid.sum(1).tolist(),
            "fp32_check": check, "b1_served": [{k: e[k] for k in (
                "problem", "shape", "ms", "plain_ms", "bound_ms", "bound_by")}
                for e in served_b1],
            "b2_served": {**served_b2[0], "per_conv": compact_gemm(served_b2[1])}}, \
        launches, served_b1, served_b2


def once_data(work):
    """Phase 20's ONCE root (`lidar_synthetic.write_once_root`), its infos
    (`create_once_infos`) and the train split's gt database
    (`create_groundtruth_database`), read back by ONCEDataset."""
    import pickle

    from dfu3d_tpu_torch.data import lidar_synthetic
    from dfu3d_tpu_torch.data.once_dataset import ONCEDataset, create_once_infos
    from dfu3d_tpu_torch.utils.config import CfgDict, cfg_from_yaml_file

    cfg = cfg_from_yaml_file(ONCE_CLI_CFG, CfgDict())
    root = work / "data" / "once"
    t0 = time.perf_counter()
    lidar_synthetic.write_once_root(root, *ONCE_FRAMES, cfg.DATA_CONFIG.POINT_CLOUD_RANGE,
                                    num_points=ONCE_POINTS, seed=21)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    create_once_infos(cfg.DATA_CONFIG, cfg.CLASS_NAMES, root, root)
    db = ONCEDataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, training=False, root_path=root) \
        .create_groundtruth_database(root / "once_infos_train.pkl",
                                     used_classes=cfg.CLASS_NAMES)
    infos_s = time.perf_counter() - t0
    dbinfos = {k: len(v) for k, v in pickle.loads(db.read_bytes()).items()}
    cfg.DATA_CONFIG.INFO_PATH["test"] = [ONCE_TEST_INFOS]
    test = ONCEDataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, training=False, root_path=root)
    n, kept = frame_points(test, test.max_points_per_frame)
    if len(test) != ONCE_FRAMES[1] or not sum(dbinfos.values()):
        fail(f"ONCE root: {len(test)} val frames, dbinfos {dbinfos}")
    log(f"[datasets] ONCE root: {ONCE_FRAMES[0]} + {ONCE_FRAMES[1]} frames of {ONCE_POINTS} "
        f"points written in {write_s:.2f} s; infos and gt database in {infos_s:.2f} s "
        f"(objects per class {dbinfos}); a test frame {n} points in range, {kept} kept")
    return root, {"write_s": write_s, "infos_and_db_s": infos_s, "dbinfos": dbinfos,
                  "points_per_frame": ONCE_POINTS, "points_in_range": n, "points_kept": kept}


def test_only_data(tag, work):
    """A phase 20 test-only root of DATASET_TEST_FRAMES val frames: Lyft's
    nuScenes-format tables with 5 sweeps, Custom's points and labels (then
    `create_custom_infos`), Argo2's converted bins and infos."""
    from dfu3d_tpu_torch.data import lidar_synthetic
    from dfu3d_tpu_torch.data.custom_dataset import create_custom_infos
    from dfu3d_tpu_torch.utils.config import CfgDict, cfg_from_yaml_file

    cfg = cfg_from_yaml_file(DATASET_TEST_CFGS[tag], CfgDict())
    pcr = cfg.DATA_CONFIG.POINT_CLOUD_RANGE
    root = work / "data" / tag
    if tag == "lyft":
        lidar_synthetic.write_lyft_root(root, 0, DATASET_TEST_FRAMES,
                                        max_sweeps=cfg.DATA_CONFIG.MAX_SWEEPS, seed=22)
    elif tag == "custom":
        lidar_synthetic.write_custom_root(root, 0, DATASET_TEST_FRAMES, pcr,
                                          num_points=DATASET_POINTS[tag], seed=23)
        create_custom_infos(cfg.DATA_CONFIG, cfg.CLASS_NAMES, root, root)
    else:
        lidar_synthetic.write_argo2_root(root, 0, DATASET_TEST_FRAMES, pcr,
                                         num_points=DATASET_POINTS[tag], seed=24)
    return root


def seeded_checkpoint(cfg_file, root, device, path):
    """The config's model at seeded weights with the BN statistics of the
    first test batch, saved as a checkpoint tools.test loads; returns (its
    path, `frame_points` of the first test frame)."""
    import torch

    _, model, _, dataset = dataset_model(cfg_file, root, device)
    torch.save({"model_state": {k: v.detach().cpu() for k, v in model.state_dict().items()},
                "epoch": 0}, path)
    return path, frame_points(dataset, dataset.max_points_per_frame)


def datasets_phase(device, card):
    """Phase 20: the other lidar datasets from disk through the CLIs at full
    width, in a temporary working directory whose cfgs/ links to
    tools/cfgs/: Waymo CenterPoint (tools.train 1 epoch, tools.test, one
    request through the kernels and the twins), ONCE CenterPoint with its gt
    database and once_eval (tools.train, tools.test), and tools.test of
    seeded checkpoints of Lyft SECOND multi-head, Custom SECOND and Argo2
    VoxelNeXt. Returns (summary, launches by path, served B1 entries, served
    B2 (totals, entries))."""
    import gc
    import os

    import torch

    def fresh_peak():
        """The peak-memory counter restarted from what is still referenced;
        returns that (GiB)."""
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated() / 2 ** 30

    cwd = os.getcwd()
    summary, launches = {"card": card}, {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        work = Path(work)
        (work / "cfgs").symlink_to(REPO / "tools" / "cfgs")
        os.chdir(work)
        try:
            # Waymo
            t0 = time.perf_counter()
            base = fresh_peak()
            root, data = waymo_data(work)
            cli, result, launches["waymo_cli_train"], launches["waymo_cli_eval"] = \
                datasets_cli("waymo", WAYMO_CLI_CFG, root, device, frames=sum(WAYMO_SEQS[1]))
            aps = {k: float(v) for k, v in result.items() if "_3d/moderate_R40" in k}
            if set(aps) != {f"{c}_3d/moderate_R40" for c in ("Car", "Pedestrian", "Bicycle")}:
                fail(f"tools.test {WAYMO_CLI_CFG}: KITTI-protocol classes {sorted(aps)}")
            request, launches["waymo_request"], served_b1, served_b2 = \
                waymo_request_check(root, device, card)
            summary["waymo"] = {"config": WAYMO_CLI_CFG[5:], "data": data, "cli": cli,
                                "ap_3d_moderate_R40": aps, "request": request,
                                "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                                "allocated_before_gib": base,
                                "seconds": time.perf_counter() - t0}
            log(f"[datasets] ({card}) Waymo CenterPoint from disk: tools.train "
                f"{cli['train_steps']} steps of B=4 ({cli['train_ms_per_step']:.1f} ms per step "
                f"with the first step's warm-up, losses "
                f"{[round(v, 4) for v in cli['train_losses']]}), tools.test {cli['eval_frames']} "
                f"frames ({cli['eval_ms_per_request']:.1f} ms per request, the first), KITTI AP "
                f"3D moderate R40 {json.dumps({k.split('_')[0]: round(v, 4) for k, v in aps.items()})}"
                f"; peak memory {summary['waymo']['peak_memory_gib']:.2f} GiB (from {base:.2f} "
                f"still allocated)")
            log(f"[time] phase 20 waymo: {summary['waymo']['seconds']:.1f} s")

            # ONCE
            t0 = time.perf_counter()
            base = fresh_peak()
            root, data = once_data(work)
            cli, result, launches["once_cli_train"], launches["once_cli_eval"] = datasets_cli(
                "once", ONCE_CLI_CFG, root, device,
                sets=("DATA_CONFIG.INFO_PATH.test", ONCE_TEST_INFOS), frames=ONCE_FRAMES[1])
            aps = {k: float(v) for k, v in result.items() if k.startswith("AP_")}
            if not {"AP_Vehicle/overall", "AP_mean/overall"} <= set(aps):
                fail(f"tools.test {ONCE_CLI_CFG}: once_eval gave {sorted(aps)}")
            summary["once"] = {"config": ONCE_CLI_CFG[5:], "data": data, "cli": cli,
                               "once_eval": aps,
                               "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                               "allocated_before_gib": base,
                               "seconds": time.perf_counter() - t0}
            log(f"[datasets] ({card}) ONCE CenterPoint from disk: tools.train "
                f"{cli['train_steps']} steps of B=4 with gt sampling "
                f"({cli['train_ms_per_step']:.1f} ms per step with the warm-up), tools.test "
                f"{cli['eval_frames']} frames ({cli['eval_ms_per_request']:.1f} ms per request); "
                f"once_eval overall AP "
                f"{json.dumps({k[3:].split('/')[0]: round(v, 4) for k, v in aps.items() if k.endswith('/overall')})}"
                f"; peak memory {summary['once']['peak_memory_gib']:.2f} GiB (from {base:.2f} "
                f"still allocated)")
            log(f"[time] phase 20 once: {summary['once']['seconds']:.1f} s")

            # Lyft, Custom, Argo2: tools.test of seeded checkpoints
            for tag, cfg_file in DATASET_TEST_CFGS.items():
                t0 = time.perf_counter()
                base = fresh_peak()
                root = test_only_data(tag, work)
                ckpt, (n, kept) = seeded_checkpoint(cfg_file, root, device,
                                                    work / f"{tag}_seeded.pth")
                cli, result, _, launches[f"{tag}_cli_eval"] = datasets_cli(tag, cfg_file, root,
                                                                          device, ckpt=ckpt)
                key = "mAP" if tag == "lyft" else "Car_3d/moderate_R40"
                if key not in result:
                    fail(f"tools.test {cfg_file}: no {key} in {sorted(result)}")
                summary[tag] = {"config": cfg_file[5:], "cli": cli, key: float(result[key]),
                                "points_in_range": n, "points_kept": kept,
                                "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                                "allocated_before_gib": base,
                                "seconds": time.perf_counter() - t0}
                log(f"[datasets] ({card}) {tag} from disk: tools.test of a seeded checkpoint, "
                    f"{cli['eval_frames']} frames ({cli['eval_ms_per_request']:.1f} ms per "
                    f"request; a frame's {n} points in range, {kept} kept by the "
                    f"collate's cap), {key} {float(result[key]):.4f}, launches "
                    f"{json.dumps(cli['eval_launches'])}; peak memory "
                    f"{summary[tag]['peak_memory_gib']:.2f} GiB (from {base:.2f} still allocated)")
                log(f"[time] phase 20 {tag}: {summary[tag]['seconds']:.1f} s")
        finally:
            os.chdir(cwd)
    torch.cuda.empty_cache()
    summary["phase_seconds"] = time.perf_counter() - t_phase
    log(f"[datasets] ({card}) phase 20 in {summary['phase_seconds']:.1f} s")
    return summary, launches, served_b1, served_b2


# phase 21: the model options and the legacy compact schemas on the configs
# derived from shipped ones (zoo.option_cfg) at full width with seeded
# weights, bf16, and the KITTI image data path
OPTIONS_DEPTH = {"centerpoint_options": (2, 2), "second_iou_height": (2, 2),
                 "voxel_rcnn_compact": (1, 1), "pv_rcnn_compact": (1, 1),
                 "pv_rcnn_plusplus_compact": (1, 1), "parta2_compact": (1, 1),
                 "voxelnext_compact": (1, 2)}   # served requests and bf16 train steps, B=4
# B2 launches per request and per train step: one per sparse conv, and a step
# adds each conv's dX but the first's (the voxel means need none):
# VoxelResBackBone8x 21, VoxelBackBone8x 12, SparseEncoder 9, SparseUNet 12;
# VoxelNeXt's compact trunk VoxelBackBone8x 12 + down16 + down32 + 2 BEV
# blocks + 6 class groups x 6 branch convs = 52
OPTIONS_B2 = {"centerpoint_options": (21, 41), "second_iou_height": (12, 23),
              "voxel_rcnn_compact": (9, 17), "pv_rcnn_compact": (9, 17),
              "pv_rcnn_plusplus_compact": (9, 17), "parta2_compact": (12, 23),
              "voxelnext_compact": (52, 103)}
# B1 launches per request and per train step: circle NMS launches none, so
# CenterPoint's one is the recall's; SECOND's NMS and recall, and in a train
# step MATCH_HEIGHT's target assignment, the three classes' 70,400 anchors
# per frame against the frames' gt slots in one launch; the two-stage models'
# proposal NMS, final NMS and recall, a step's proposal NMS and RoI targets;
# VoxelNeXt's NMS and recall
OPTIONS_B1 = {"centerpoint_options": (1, 0), "second_iou_height": (2, 1),
              "voxel_rcnn_compact": (3, 2), "pv_rcnn_compact": (3, 2),
              "pv_rcnn_plusplus_compact": (3, 2), "parta2_compact": (3, 2),
              "voxelnext_compact": (2, 0)}
OPTIONS_NUSC = ("centerpoint_options", "voxelnext_compact")   # on the nuScenes root
OPTIONS_TWO_STAGE = ("voxel_rcnn_compact", "pv_rcnn_compact", "pv_rcnn_plusplus_compact",
                     "parta2_compact")
OPTIONS_NUSC_FRAMES = (4, 4)   # phase 21's nuScenes root: train, val key frames
OPTIONS_IMAGE_SEED = 21
# MATCH_HEIGHT's labels through B1 and its twin may flip where an overlap
# sits within the two runs' rounding of a decision; at most this many
OPTIONS_LABEL_FLIPS = 4
CADDN_CFG = "cfgs/kitti_models/CaDDN.yaml"   # from phase 21's work dir


def options_data(work):
    """Phase 21's data: a synthetic nuScenes root (OPTIONS_NUSC_FRAMES key
    frames with 9 sweeps each and their infos) and phase 14's KITTI root
    (`two_stage_root`: 8 + 4 frames, infos and the gt database) whose
    image_2 PNGs are rewritten with seeded random RGB pixels (1240 x 370,
    which compress to about their raw size: a slow case for the decoder).
    Returns (nuScenes root and infos, KITTI root and infos, summary)."""
    import numpy as np

    from dfu3d_tpu_torch.data import kitti_synthetic, nuscenes_synthetic

    t0 = time.perf_counter()
    nusc = work / "data" / "nuscenes"
    written = nuscenes_synthetic.write_root(nusc, *OPTIONS_NUSC_FRAMES)
    nusc_infos = nuscenes_synthetic.write_infos(nusc, written, NUSC_SWEEPS)
    nusc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    kitti, kitti_infos = two_stage_root(work)
    rng = np.random.RandomState(OPTIONS_IMAGE_SEED)
    pngs = sorted((kitti / "image_2").glob("*.png"))
    for png in pngs:
        kitti_synthetic.write_png_rgb(png, rng.randint(
            0, 256, (kitti_synthetic.IMG_H, kitti_synthetic.IMG_W, 3), dtype=np.uint8))
    kitti_s = time.perf_counter() - t0
    mib = sum(p.stat().st_size for p in pngs) / len(pngs) / 2 ** 20
    log(f"[options] data: nuScenes root {OPTIONS_NUSC_FRAMES} key frames in {nusc_s:.1f} s; "
        f"KITTI root {TWO_STAGE_FRAMES} frames with infos, the gt database and random RGB "
        f"PNGs ({mib:.2f} MiB each) in {kitti_s:.1f} s")
    return (nusc, nusc_infos), (kitti, kitti_infos), {
        "nuscenes_seconds": nusc_s, "kitti_seconds": kitti_s, "png_mib": mib}


def options_batches(name, cfg, data, count, training):
    """`count` batches of B=4 for a phase 21 model: nuScenes key frames with
    9 sweeps (OPTIONS_NUSC), else KITTI frames, from phase 21's roots. The
    nuScenes configs train on phase 6's synthetic batches (60,000 points,
    16 gt per frame over the ten classes, 10-column gt) with a zero time-lag
    column: four key frames of the synthetic root hold few boxes of some
    classes once augmented, and a class group without gt in every step
    leaves its regression towers untrained, which `train` takes for a
    fault."""
    import torch

    from dfu3d_tpu_torch import zoo
    from dfu3d_tpu_torch.data.batch import synthetic_batch

    split = "train" if training else "val"
    if name in OPTIONS_NUSC and training:
        out = []
        for s in range(count):
            b = synthetic_batch(4, 60000, 256, 50.0, seed=s, velocity=True)
            out.append(b._replace(points=torch.cat([b.points, torch.zeros_like(b.points[..., :1])],
                                                   dim=-1)))
        return out
    if name in OPTIONS_NUSC:
        root, infos = data["nuscenes"]
        return zoo.nuscenes_batches(cfg, root, infos[split], count, training=training)
    root, infos = data["kitti"]
    return zoo.kitti_batches(cfg, root, infos[split], count, 4, training=training)


def options_serve(name, model, batches, device, b1=None, b2=None, tag="options"):
    """A warm-up request, the peak memory and every kernel count set to 0,
    the requests through eval_batches (bf16), the counts and the peak read.
    Fatal unless every request launched B1 `b1` times and the tensor-core B2
    `b2` times (by default as OPTIONS_B1 and OPTIONS_B2 say) and no
    CUDA-core B2, or on a non-finite or empty output. Returns (EvalResult,
    launches, summary)."""
    import torch

    from dfu3d_tpu_torch.train.eval_utils import eval_batches

    eval_batches(model, batches[:1], RECALL_THRESH, device=device, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res = eval_batches(model, batches, RECALL_THRESH, device=device, dtype=torch.bfloat16)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    n = len(batches)
    for k, (boxes, scores, labels, valid) in enumerate(res.preds):
        if not torch.isfinite(boxes[valid]).all() or not torch.isfinite(scores).all() or \
                not valid.any(dim=1).all():
            fail(f"{name} request {k}: boxes {tuple(boxes.shape)}, kept boxes finite "
                 f"{bool(torch.isfinite(boxes[valid]).all())}, kept per frame "
                 f"{valid.sum(1).tolist()}")
    b1 = OPTIONS_B1[name][0] if b1 is None else b1
    b2 = OPTIONS_B2[name][0] if b2 is None else b2
    if launches["iou_bev_overlap"] != b1 * n or launches["gather_gemm_tensor_core"] != b2 * n \
            or launches["gather_gemm_cuda_core"]:
        fail(f"{name} serving: kernel launches {launches} for {n} requests, not {b1} B1 and "
             f"{b2} tensor-core B2 per request")
    ms = [s * 1e3 for s in res.batch_seconds]
    summary = {"request_ms": {"median": statistics.median(ms),
                              "median_after_first": statistics.median(ms[1:] or ms), "all": ms},
               "kept_per_frame": [p[3].sum(1).tolist() for p in res.preds],
               "recall": res.metric, "launches": launches,
               "launches_per_request": {k: v / n for k, v in launches.items()},
               "peak_memory_gib": peak / 2 ** 30}
    log(f"[{tag}] {name} serving, {n} requests of B=4 (bf16): ms per request median "
        f"{summary['request_ms']['median']:.2f} (all: {', '.join(f'{v:.2f}' for v in ms)}); "
        f"peak memory {summary['peak_memory_gib']:.2f} GiB; kept per frame "
        f"{summary['kept_per_frame']}; launches per request "
        f"{json.dumps(summary['launches_per_request'])}")
    return res, launches, summary


def check_request_paths(name, model, batch, device):
    """One fp32 request through the kernels and through their plain twins
    (CenterPoint with circle NMS, whose suppression reads no overlap): keep
    masks equal, the kept (box, score, label) rows equal within PATH_TOL
    when matched one to one per frame (`set_match_err`, as `check_paths`:
    two kept boxes whose scores differ by less than the two summation
    orders' rounding take their output slots in either order), recall
    counters equal. How many slots differ slot by slot is reported."""
    import torch

    from dfu3d_tpu_torch.core.geometry import iou_kernel
    from dfu3d_tpu_torch.core.voxel import gather_gemm_kernel
    from dfu3d_tpu_torch.train.train_state import make_eval_step

    step = make_eval_step(model, RECALL_THRESH, device=device)
    kb, ks, kl, kv, krec = step(batch)
    with plain_twins([(iou_kernel, "overlap_bev", "overlap_bev_plain"),
                      (gather_gemm_kernel, "gather_gemm", "gather_gemm_plain")]):
        pb, ps, pl, pv, prec = step(batch)
    krec, prec = ({k: int(v) for k, v in r.items()} for r in (krec, prec))
    if not kv.any() or not torch.equal(kv, pv) or krec != prec:
        fail(f"{name} fp32 path: keep masks equal {torch.equal(kv, pv)} ({int(kv.sum())} kept), "
             f"recall {krec} vs {prec}")
    match_err = set_match_err(name, (kb, ks, kl, kv), (pb, ps, pl, pv))
    slot_diff = (((kb - pb).abs().amax(-1) > PATH_TOL) | ((ks - ps).abs() > PATH_TOL)
                 | (kl != pl)) & kv
    if not match_err <= PATH_TOL:
        fail(f"{name} fp32 path: kept boxes, scores and labels differ by {match_err} (tol "
             f"{PATH_TOL}) when matched as sets; largest |box| per column "
             f"{kb.abs()[kv].amax(0).tolist()}")
    log(f"[check] {name} fp32 whole path, kernels vs plain: keep masks equal "
        f"({int(kv.sum())} kept), kept boxes, scores and labels equal as sets within "
        f"{match_err:.3g}; {int(slot_diff.sum())} slots differ slot by slot (near-tied scores "
        f"in either order); recall {krec}")
    return {"kept": int(kv.sum()), "max_set_diff": match_err,
            "slots_differing": int(slot_diff.sum()), "recall": krec}


def label_flips(kernel, twin):
    """MATCH_HEIGHT's assignments of one class through B1 and through its
    twin, each (masked 3D IoU (B, A, M), labels (B, A), matched, unmatched
    thresholds): [(frame, anchor, kernel label, twin label, explained)],
    an anchor's flip explained where the two runs' overlaps put it within
    their largest difference `s` (doubled) of a decision: its best overlap
    at a threshold, or a near-tie at some gt's largest overlap in both runs
    (the force-match compares overlaps with the column maximum for
    equality, each run on its own tensor)."""
    (i0, l0, hi, lo), (i1, l1, _, _) = kernel, twin
    s = 2 * max((i0 - i1).abs().max().item(), 2.0 ** -24)
    c0, c1 = i0.amax(dim=1), i1.amax(dim=1)   # (B, M): each gt's largest overlap
    out = []
    for b, a in (l0 != l1).nonzero().tolist():
        r0, r1 = i0[b, a], i1[b, a]
        at_threshold = any(abs(r.max().item() - t) <= s for r in (r0, r1) for t in (hi, lo))
        tie = ((c0[b] > 0) & ((r0 - c0[b]).abs() <= s) & ((r1 - c1[b]).abs() <= s)).any().item()
        out.append((b, a, int(l0[b, a]), int(l1[b, a]), bool(at_threshold or tie)))
    return out


def check_match_height_step(model, batch, device):
    """second_iou_height's fp32 train step through the kernels against the
    twins, as phase 14 holds a two-stage step: B1 first, the train forward
    (B2 through the kernel) with MATCH_HEIGHT's overlaps through B1 and
    through its twin, the twin run going on with the kernel run's targets
    (as phase 14's B2 runs go on with the kernel run's RoIs): the loss within
    TRAIN_LOSS_TOL relative; the labels each run assigns on its own equal,
    but for flips that the two runs' rounding explains (`label_flips`: an
    overlap within their largest difference of a threshold, or a near-tie
    at a gt's largest overlap), at most OPTIONS_LABEL_FLIPS of them, each
    reported; positives among them. Then B2 (`check_train_paths` with B2
    swapped), conv_iou's gradient nonzero."""
    import torch

    from dfu3d_tpu_torch.core.geometry import iou_kernel
    from dfu3d_tpu_torch.core.voxel import gather_gemm_kernel
    from dfu3d_tpu_torch.models import pointpillar

    batch = batch.to(device)
    weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    runs, assign = [], pointpillar.assign_targets_single_class

    def recording(*a, **k):
        out = assign(*a, **k)
        iou = torch.where(a[2][:, None, :], k["iou"], -1.0)   # gt_mask, as the assigner masks
        runs[-1].append(((iou.clone(), out[0].clone(), a[4], a[5]), out))
        return runs[0][len(runs[-1]) - 1][1]                  # the kernel run's targets

    def forward(plain_b1):
        runs.append([])
        with plain_twins([(iou_kernel, "overlap_bev", "overlap_bev_plain")] if plain_b1 else []):
            model.load_state_dict(weights)
            model.train()
            with torch.no_grad():
                loss, _ = model(batch)
        return loss.item()

    pointpillar.assign_targets_single_class = recording
    try:
        k_loss, p_loss = forward(False), forward(True)
    finally:
        pointpillar.assign_targets_single_class = assign
    model.load_state_dict(weights)
    rel = abs(k_loss - p_loss) / abs(p_loss)
    flips = [f for (kern, _), (twin, _) in zip(*runs) for f in label_flips(kern, twin)]
    positives = sum(int((kern[1] > 0).sum()) for kern, _ in runs[0])
    iou_diff = max((kern[0] - twin[0]).abs().max().item() for (kern, _), (twin, _) in zip(*runs))
    if not all(f[4] for f in flips) or len(flips) > OPTIONS_LABEL_FLIPS or not positives or \
            not rel <= TRAIN_LOSS_TOL:
        fail(f"second_iou_height fp32 train forward, B1 vs its twin: MATCH_HEIGHT labels differ "
             f"on {len(flips)} anchors (frame, anchor, kernel, twin, explained by rounding) "
             f"{flips[:8]}; {positives} positive; largest |3D IoU kernel - twin| {iou_diff:.3g}; "
             f"loss on the kernel run's targets {rel:.3g} relative")
    check = check_train_paths("second_iou_height", model, batch,
                              [(gather_gemm_kernel, "gather_gemm", "gather_gemm_plain")],
                              device, scales=True)
    iou_grad = check.pop("leaf_scales")["dense_head.conv_iou.weight"]
    if not iou_grad > 0:
        fail(f"second_iou_height fp32 train step: conv_iou's largest gradient {iou_grad:.3g}")
    check.update(b1_loss_rel_err=rel, label_flips=flips, positive_anchors=positives,
                 max_iou3d_diff=iou_diff, conv_iou_grad_max=iou_grad)
    log(f"[options] second_iou_height fp32 train step: MATCH_HEIGHT's labels through B1 and "
        f"its twin {'equal' if not flips else f'equal but {len(flips)} flips at rounding'} "
        f"({positives} positive anchors; 3D IoUs within {iou_diff:.3g}), loss {rel:.2e} "
        f"relative; conv_iou's largest gradient {iou_grad:.3g}")
    return check


def options_model(name, data, device, card):
    """Phase 21 for one model: serving at seeded weights (the BN statistics
    of the first request for OPTIONS_NUSC: nuScenes intensities reach 255),
    launches, ms, peak memory; the fp32 request through the kernels and the
    twins (centerpoint_options on the same top-K peaks, `replayed_queries`;
    voxel_rcnn_compact and voxelnext_compact by `check_paths`); VoxelNeXt's
    52 served B2 calls held and timed; SECOND's fp32 train step and its
    MATCH_HEIGHT B1 call held and timed; then OPTIONS_DEPTH's bf16 steps
    through train_model (the two-stage models on `zoo.proposal_gt`'s gt),
    fatal unless each launches B1 and B2 as OPTIONS_B1 and OPTIONS_B2 say.
    Returns (summary, launches by path, train B1 entries, served B2
    (totals, entries) or None)."""
    import torch

    from dfu3d_tpu_torch import zoo
    from dfu3d_tpu_torch.core.geometry import iou_kernel
    from dfu3d_tpu_torch.core.voxel import gather_gemm_kernel
    from dfu3d_tpu_torch.flagship import calibrate_bn_, seeded_weights_
    from dfu3d_tpu_torch.models import center_head
    from dfu3d_tpu_torch.train.train_state import make_eval_step

    build = getattr(zoo, name)
    requests, train_steps = OPTIONS_DEPTH[name]
    swaps = [(iou_kernel, "overlap_bev", "overlap_bev_plain"),
             (gather_gemm_kernel, "gather_gemm", "gather_gemm_plain")]
    seconds, launches, train_b1, served_b2 = {}, {}, [], None
    t0 = time.perf_counter()
    cfg, grid, model = build(device=device)
    seeded_weights_(model, seed=0)
    batches = options_batches(name, cfg, data, requests, training=False)
    if name in OPTIONS_NUSC:
        calibrate_bn_(model, batches[0])
    log(f"[options] {name}: {cfg.MODEL.NAME} {'x'.join(map(str, grid.grid_size))} grid, "
        f"{sum(p.numel() for p in model.parameters())} parameters; points per request "
        f"{[b.points_valid.sum(1).tolist() for b in batches]}")
    res, launches[name], serve = options_serve(name, model, batches, device)
    if name == "centerpoint_options":
        with replayed_queries(center_head, per_run=model.dense_head.num_heads) as replay:
            serve["fp32_check"] = check_request_paths(name, model, batches[0], device)
        serve["fp32_check"]["peaks_replayed"] = replay.swapped
    elif name in ("voxel_rcnn_compact", "voxelnext_compact"):
        serve["fp32_check"] = check_paths(name, model, cfg, batches[0], res.preds[0], swaps,
                                          device)
    if name == "voxelnext_compact":
        calls = record_gemm_calls(lambda: make_eval_step(
            model, device=device, dtype=torch.bfloat16)(batches[0]))
        if len(calls) != OPTIONS_B2[name][0]:
            fail(f"one {name} eval step made {len(calls)} gather-GEMM calls")
        served_b2 = hold_gemm_calls(f"{name}, one served request",
                                    ((f"conv{i}", c) for i, c in enumerate(calls)))
        serve["b2_served"] = {**served_b2[0], "per_conv": compact_gemm(served_b2[1])}
        del calls
    seconds["serve"] = time.perf_counter() - t0
    del res, model
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    tbatches = options_batches(name, cfg, data, train_steps, training=True)
    if name in OPTIONS_TWO_STAGE or name == "second_iou_height":
        _, _, model = build(device=device, train=True)
        seeded_weights_(model, seed=0)
        if name == "second_iou_height":
            serve["fp32_train_check"] = check_match_height_step(model, tbatches[0], device)
            train_b1 = train_overlaps(name, model, tbatches[0], device, names=("match_height",))
        else:
            reset_launches()
            tbatches = [zoo.proposal_gt(model, bt, torch.bfloat16) for bt in tbatches]
            launches[f"{name}_gt"] = read_launches()
        del model
    model, launches[f"{name}_train"], steps, _ = train(name, build, tbatches, device)
    b1, b2 = OPTIONS_B1[name][1], OPTIONS_B2[name][1]
    bad = [s["it"] for s in steps if s["iou_bev_overlap"] != b1
           or s["gather_gemm_tensor_core"] != b2 or s["gather_gemm_cuda_core"]]
    if bad:
        fail(f"{name} train steps {bad} did not launch B1 {b1} and the tensor-core B2 {b2} "
             f"times: {steps}")
    seconds["train"] = time.perf_counter() - t0
    ms = [s["host_ms"] for s in steps]
    summary = {"config": f"zoo.option_cfg('{name}') from tools/cfgs/{zoo.OPTION_CFGS[name]}",
               "card": card, "serve": serve,
               "train": {"batch": 4, "steps": steps,
                         "ms_per_step": {"median": statistics.median(ms), "all": ms},
                         "launches": launches[f"{name}_train"],
                         "b1_launches_per_step": b1, "b2_launches_per_step": b2,
                         "b1_match_height": [{k: e[k] for k in (
                             "problem", "shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                             "bound_by")} for e in train_b1]},
               "phase_seconds": seconds}
    log(f"[options] ({card}) {name}: request median {serve['request_ms']['median']:.2f} ms, "
        f"train step median {statistics.median(ms):.2f} ms (B=4, bf16); seconds "
        f"{json.dumps({k: round(v, 2) for k, v in seconds.items()})}")
    del model
    torch.cuda.empty_cache()
    return summary, launches, train_b1, served_b2


def write_cfg_yaml(cfg, path):
    """A config (CfgDict, its base configs merged) as a YAML file the CLIs
    read with --cfg_file."""
    import yaml

    def plain(v):
        if isinstance(v, dict):
            return {k: plain(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [plain(x) for x in v]
        return v

    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(yaml.safe_dump(plain(cfg), sort_keys=False))
    return path


def options_cli(work, root, device):
    """second_iou_height from disk: its derived config written as a YAML
    file, tools.train for 1 epoch (8 train frames, B=4, gt sampling and the
    world augmentations, bf16) and tools.test --ckpt of its checkpoint on
    the val split; fatal on a non-finite loss, no checkpoint, a train step
    that does not launch B1 once (MATCH_HEIGHT) and the tensor-core B2 23
    times, an eval batch that does not launch B1 twice and B2 12 times, a
    missing KITTI txt or no Car in the AP_DICT."""
    from dfu3d_tpu_torch import zoo
    from dfu3d_tpu_torch.tools import test as test_cli, train as train_cli

    cfg_file = write_cfg_yaml(zoo.option_cfg("second_iou_height"),
                              work / "cfgs" / "options" / "second_iou_height.yaml")
    common = ["--cfg_file", str(cfg_file.relative_to(work)), "--workers", str(LOADER_WORKERS),
              "--extra_tag", "chip_smoke"]
    data_path = ["--set", "DATA_CONFIG.DATA_PATH", str(root)]
    b1, b2 = OPTIONS_B1["second_iou_height"], OPTIONS_B2["second_iou_height"]
    reset_launches()
    t0 = time.perf_counter()
    trained = train_cli.main([*common, "--epochs", "1", *data_path])
    train_s = time.perf_counter() - t0
    train_launches = read_launches()
    (epoch,) = trained["epochs"]
    ckpt = trained["ckpt_dir"] / "checkpoint_epoch_1.pth"
    if not epoch["steps"] or not all(math.isfinite(v) for v in epoch["losses"]) or \
            not ckpt.exists() or train_launches["iou_bev_overlap"] != b1[1] * epoch["steps"] or \
            train_launches["gather_gemm_tensor_core"] != b2[1] * epoch["steps"] or \
            train_launches["gather_gemm_cuda_core"]:
        fail(f"tools.train second_iou_height: {epoch}, checkpoint {ckpt.exists()}, kernel "
             f"launches {train_launches} (want B1 {b1[1]} and B2 {b2[1]} per step)")
    reset_launches()
    t0 = time.perf_counter()
    ((_, result_dir, res),) = test_cli.main([*common, "--ckpt", str(ckpt), "--save_to_file",
                                             *data_path])
    test_s = time.perf_counter() - t0
    eval_launches = read_launches()
    txts = len(list((result_dir / "final_result" / "data").glob("*.txt")))
    batches = res["eval_batches"]
    if txts != TWO_STAGE_FRAMES[1] or "Car_3d/moderate_R40" not in res or \
            eval_launches["iou_bev_overlap"] != b1[0] * batches or \
            eval_launches["gather_gemm_tensor_core"] != b2[0] * batches:
        fail(f"tools.test second_iou_height: {txts} txts for {TWO_STAGE_FRAMES[1]} val frames, "
             f"kernel launches {eval_launches} for {batches} batches")
    log(f"[options] second_iou_height from disk: tools.train {epoch['steps']} steps, losses "
        f"{[round(v, 4) for v in epoch['losses']]}, {train_s:.2f} s, launches "
        f"{json.dumps(train_launches)}; tools.test {res['num_frames']} frames, {txts} KITTI "
        f"txts, {test_s:.2f} s, Car 3D moderate R40 {res['Car_3d/moderate_R40']:.2f}, launches "
        f"{json.dumps(eval_launches)}")
    return ({"train": {"steps": epoch["steps"], "losses": epoch["losses"], "seconds": train_s,
                       "launches": train_launches},
             "eval": {"num_frames": res["num_frames"], "txts": txts, "seconds": test_s,
                      "launches": eval_launches,
                      "car_3d_moderate_R40": res["Car_3d/moderate_R40"]}},
            train_launches, eval_launches)


def options_images(root, infos, card):
    """CaDDN.yaml's train items from phase 21's KITTI root (images, 2D gt
    boxes and points in GET_ITEM_LIST; random_image_flip from a seeded
    generator; image_normalization): every frame's image (370, 1240, 3)
    float32, finite and normalised, its 2D gt boxes (the label's, which the
    range mask does not filter, in either package) and its points, some
    frames flipped and some not; then on this host frames/s of
    `get_image` alone (the PNG read and decode) and of the whole train item
    (the image, the points, the flip and the normalisation), each over two
    passes of the root's train frames. No kernel runs."""
    import numpy as np

    from dfu3d_tpu_torch.data import kitti_synthetic
    from dfu3d_tpu_torch.data.kitti_dataset import KittiDataset
    from dfu3d_tpu_torch.utils.config import CfgDict, cfg_from_yaml_file

    cfg = cfg_from_yaml_file(CADDN_CFG, CfgDict())
    ds_cfg = cfg.DATA_CONFIG
    ds_cfg.DATA_PATH = str(root)
    ds_cfg.INFO_PATH = {"train": [str(infos["train"])], "test": [str(infos["val"])]}
    ds = KittiDataset(ds_cfg, cfg.CLASS_NAMES, training=True, root_path=root)
    ds.data_augmentor.rng = np.random.RandomState(OPTIONS_IMAGE_SEED)
    n, flipped = len(ds), 0
    for i in range(n):
        item = ds[i]
        img = item.get("images")
        if img is None or img.shape != (kitti_synthetic.IMG_H, kitti_synthetic.IMG_W, 3) or \
                img.dtype != np.float32 or not np.isfinite(img).all() or \
                not -2.2 < img.min() < -1.5 or not 2.0 < img.max() < 2.7 or \
                not len(item.get("gt_boxes2d", ())) or not len(item["points"]):
            stats = None if img is None else (img.shape, img.dtype, float(img.min()),
                                              float(img.max()))
            fail(f"CaDDN.yaml train item {i}: keys {sorted(item)}, image {stats}")
        flipped += bool(item.get("image_flipped"))
    if not 0 < flipped < n:
        fail(f"CaDDN.yaml train items: {flipped} of {n} flipped")
    ids = [info["point_cloud"]["lidar_idx"] for info in ds.kitti_infos]
    t0 = time.perf_counter()
    for _ in range(2):
        for idx in ids:
            ds.get_image(idx)
    image_fps = 2 * len(ids) / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    for _ in range(2):
        for i in range(n):
            ds[i]
    item_fps = 2 * n / (time.perf_counter() - t0)
    log(f"[options] ({card}) CaDDN.yaml train items from disk: {n} frames ({flipped} flipped), "
        f"images 370 x 1240 normalised; on this host get_image {image_fps:.2f} frames/s, the "
        f"whole train item {item_fps:.2f} frames/s (one process)")
    return {"frames": n, "flipped": flipped, "get_image_frames_per_s": image_fps,
            "item_frames_per_s": item_fps}


def options_phase(device, card):
    """Phase 21: the seven configs derived from shipped ones (zoo.option_cfg:
    centerpoint_options, second_iou_height, voxel_rcnn_compact,
    pv_rcnn_compact, pv_rcnn_plusplus_compact, parta2_compact,
    voxelnext_compact) at full width with seeded weights on a synthetic
    nuScenes root and a KITTI root with RGB PNGs, in a temporary working
    directory whose cfgs/ links to tools/cfgs/; second_iou_height from disk
    through tools.train and tools.test; CaDDN.yaml's image items and their
    frames/s. Returns (summary, launches by path, train B1 entries, served
    B2 (totals, entries) of voxelnext_compact)."""
    import os

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as work:
        work = Path(work)
        (work / "cfgs").mkdir()
        for sub in (REPO / "tools" / "cfgs").iterdir():
            (work / "cfgs" / sub.name).symlink_to(sub)
        os.chdir(work)
        try:
            nusc, kitti, data_summary = options_data(work)
            data = {"nuscenes": nusc, "kitti": kitti}
            summary = {"card": card, "data": data_summary}
            launches, train_b1, served_b2 = {}, [], None
            for name in OPTIONS_DEPTH:
                out = options_model(name, data, device, card)
                summary[name] = out[0]
                launches.update(out[1])
                train_b1 += out[2]
                served_b2 = out[3] or served_b2
            summary["second_iou_height_cli"], launches["second_iou_height_cli_train"], \
                launches["second_iou_height_cli_eval"] = options_cli(work, kitti[0], device)
            summary["images"] = options_images(*kitti, card)
        finally:
            os.chdir(cwd)
    return summary, launches, train_b1, served_b2


# phase 22: the column formulation of VoxelBackBone8x (zoo.second_column:
# KITTI second.yaml with BACKBONE_3D.FORMULATION column) at full width, its
# A/B against the gather form, the demo, the profiling trace and the
# integrated gt database
AUX_DEPTH = (3, 3)      # second_column: served requests and bf16 train steps, B=4
# B1 per request (NMS, recall) and per train step; the column trunk launches
# no B2, the gather form's VoxelBackBone8x 12 per request and 23 per step
AUX_B1 = (2, 0)
AUX_GATHER_B2 = (12, 23)
AUX_DEMO_FILES = 4
AUX_DEMO_B1 = 1         # per file: the demo's eval step runs the NMS and no recall
# voxels: the A/B's caps where one binds at the config's (the stage caps are a half, a
# quarter and an eighth of it): the KITTI frames' 32,500 voxels keep 31,500 / 27,600 /
# 10,400 at strides 2 / 4 / 8 and 13,700 after the column form's conv_out
AUX_AB_VOXEL_CAP = 160000
AUX_TRACE_KERNEL = "overlap_bev_kernel"   # B1's CUDA kernel, as the trace names it


def aux_gather(train=False, device="cuda"):
    """second.yaml in the gather form: zoo.second_column's config with
    FORMULATION gather, built as the CLIs build it."""
    from dfu3d_tpu_torch import zoo
    from dfu3d_tpu_torch.tools.common import build_model, model_grid

    cfg = zoo.option_cfg("second_column")
    cfg.MODEL.BACKBONE_3D.FORMULATION = "gather"
    return cfg, model_grid(cfg), build_model(cfg, "train" if train else "test", device,
                                             train=train)


def aux_stage_counts(model, batch, device):
    """Per frame, the voxelizer's distinct cells against max_voxels and
    every stage of the trunk against its cap: the column form's columns
    (and active voxels) per set and the final compaction's active voxels
    against its slots; the gather form's voxels per set. Returns (counts,
    whether a cap of the trunk binds)."""
    import torch

    from dfu3d_tpu_torch.models.column_sparse import ColumnVoxelBackBone8x

    bb = model.backbone_3d
    with torch.no_grad():
        b = batch.to(device)
        _, vox = model.vfe(b.points, b.points_valid)
        plan = bb.plan(vox.voxel_coords, vox.voxel_valid, vox.num_unique)
    caps = [bb.voxel_cap] + bb.caps + [bb.caps[2]]
    out = {"voxelizer": {"cells": vox.num_unique.tolist(), "cap": model.vfe.max_voxels}}
    binds = False
    if isinstance(bb, ColumnVoxelBackBone8x):
        for i, (lv, cap) in enumerate(zip(plan.levels, caps)):
            voxels = (lv.zmask & lv.col_valid[..., None]).sum((1, 2))
            if i < 4:
                out[f"stage{i}"] = {"columns": lv.num_cols.tolist(), "column_cap": cap,
                                    "voxels": voxels.tolist()}
                binds |= bool((lv.num_cols > cap).any())
            else:
                out["conv_out"] = {"voxels": voxels.tolist(), "slots": bb.out_cap}
                binds |= bool((voxels > bb.out_cap).any())
    else:
        for i, (lv, cap) in enumerate(zip(plan, caps)):
            out["conv_out" if i == 4 else f"stage{i}"] = {"voxels": lv.num_unique.tolist(),
                                                          "voxel_cap": cap}
            binds |= i > 0 and bool((lv.num_unique > cap).any())
    return out, binds


def aux_forms_agree(column, gather, batch, device):
    """One fp32 request of each form on the same weights: the trunks'
    output sets equal slot for slot, and within PATH_TOL their features,
    the head's maps and every anchor's decoded box and score. A direction
    bin may differ only where both forms' two direction logits lie within
    twice the maps' largest difference of each other (the heading then
    differs by pi, the footprint not at all). The NMS runs on each form's
    boxes in the column form's score order: the same slots kept, their
    boxes and scores within PATH_TOL. At seeded weights many overlapping
    anchors score within the two summation orders' rounding of each other
    (every anchor over empty ground scores the same), so NMS on each form's
    own scores keeps other boxes among those; how many is reported. Returns
    (agreement, a list of what differs, empty where they agree)."""
    import torch

    from dfu3d_tpu_torch.core.geometry.nms import nms_bev
    from dfu3d_tpu_torch.models.sparse_backbone import height_compression

    outs = []
    with torch.no_grad():
        b = batch.to(device)
        for m in (column, gather):
            m.eval()
            feats, vox = m.vfe(b.points, b.points_valid)
            bb = m.backbone_3d
            st = bb(feats, bb.plan(vox.voxel_coords, vox.voxel_valid, vox.num_unique))
            head = m.dense_head(m.backbone_2d(height_compression(st)))
            boxes, cls = m.decode(head)
            outs.append((st, head, boxes, cls.amax(-1)))
    (sc, hc, bc, mc), (sg, hg, bg, mg) = outs
    faults = []
    trunk_err = None
    if not (torch.equal(sc.valid, sg.valid) and torch.equal(sc.coords, sg.coords)):
        faults.append(f"trunk output sets differ ({sc.valid.sum(1).tolist()} / "
                      f"{sg.valid.sum(1).tolist()} voxels)")
    else:
        trunk_err = (sc.features.float() - sg.features.float()).abs().max().item()
        if not trunk_err <= PATH_TOL:
            faults.append(f"trunk features differ by {trunk_err:.3g}")
    head_err = {k: (hc[k].float() - hg[k].float()).abs().max().item()
                for k in hc if torch.is_tensor(hc[k])}
    if not max(head_err.values()) <= PATH_TOL:
        faults.append(f"head maps differ by {head_err}")
    nb = bc.shape[0]
    dc, dg = (h["dir_cls_preds"].float().reshape(nb, -1, 2) for h in (hc, hg))
    flipped = dc.argmax(-1) != dg.argmax(-1)
    tie = 2 * head_err["dir_cls_preds"]
    unexplained = flipped & (((dc[..., 1] - dc[..., 0]).abs() > tie)
                             | ((dg[..., 1] - dg[..., 0]).abs() > tie))
    heading = (bc[..., 6] - bg[..., 6]).abs()
    heading = torch.where(flipped, (heading - math.pi).abs(), heading)
    box_err = max((bc[..., :6] - bg[..., :6]).abs().max().item(), heading.max().item())
    score_err = (mc - mg).abs().max().item()
    if unexplained.any() or not max(box_err, score_err) <= PATH_TOL:
        faults.append(f"decoded anchors: boxes within {box_err:.3g}, scores within "
                      f"{score_err:.3g}, {int(flipped.sum())} direction bins differ "
                      f"({int(unexplained.sum())} beyond a tie of {tie:.3g})")
    pp = column.model_cfg.POST_PROCESSING
    thresh = float(pp.get("SCORE_THRESH", 0.1))
    args = dict(thresh=float(pp.NMS_CONFIG.NMS_THRESH), pre_max=int(pp.NMS_CONFIG.NMS_PRE_MAXSIZE),
                post_max=int(pp.NMS_CONFIG.NMS_POST_MAXSIZE))
    (sel_c, keep_c), (sel_g, keep_g), (sel_o, keep_o) = (
        nms_bev(x, sx, valid=sx >= thresh, **args) for x, sx in ((bc, mc), (bg, mc), (bg, mg)))
    kept = int(keep_c.sum())
    if not kept or not (torch.equal(sel_c, sel_g) and torch.equal(keep_c, keep_g)):
        faults.append(f"NMS in the column form's score order keeps {kept} / "
                      f"{int(keep_g.sum())} boxes, {int((keep_c != keep_g).sum())} slots differ")
    differ = sum(len(set(sel_c[i][keep_c[i]].tolist()) ^ set(sel_o[i][keep_o[i]].tolist()))
                 for i in range(nb))
    return {"trunk_max_diff": trunk_err, "head_max_diff": head_err,
            "decoded_box_max_diff": box_err, "decoded_score_max_diff": score_err,
            "direction_bins_differing_at_ties": int(flipped.sum()),
            "kept_in_column_order": kept,
            "kept_boxes_differing_in_own_order": differ}, faults


def aux_ab_check(cfg, column, gather, batch, device):
    """The fp32 A/B on one batch: each form's stage counts against its caps
    and one fp32 request of each (`aux_forms_agree`), at the config's caps
    (fatal where no cap binds, reported where one does), then, where one
    binds, with both forms rebuilt at AUX_AB_VOXEL_CAP voxels (the same
    weights; the caps are no parameters), where none may bind: fatal."""
    import copy

    from dfu3d_tpu_torch.tools.common import _voxel_processor, build_model

    def counts_of(pair):
        out, binds = {}, False
        for name, m in zip(("column", "gather"), pair):
            out[name], bound = aux_stage_counts(m, batch, device)
            binds |= bound
        return out, binds

    counts, binds = counts_of((column, gather))
    log(f"[aux] fp32 A/B stage counts (per frame; columns and voxels against their caps; "
        f"a cap binds: {binds}): {json.dumps(counts)}")
    full, faults = aux_forms_agree(column, gather, batch, device)
    summary = {"stage_counts": counts, "cap_binds": binds, "at_config_caps": full}
    if not binds:
        if faults:
            fail(f"second_column fp32 request vs the gather form, no cap binding: {faults}")
        case = "no cap binds at the config's caps: the forms agree"
    else:
        cfg = copy.deepcopy(cfg)
        _voxel_processor(cfg).MAX_NUMBER_OF_VOXELS["test"] = AUX_AB_VOXEL_CAP
        raised = []
        for form, src in (("column", column), ("gather", gather)):
            cfg.MODEL.BACKBONE_3D.FORMULATION = form
            m = build_model(cfg, "test", device)
            m.load_state_dict(src.state_dict())
            raised.append(m.eval())
        rcounts, rbinds = counts_of(raised)
        if rbinds:
            fail(f"second_column A/B: a cap binds at {AUX_AB_VOXEL_CAP} voxels too: {rcounts}")
        agree, rfaults = aux_forms_agree(*raised, batch, device)
        if rfaults:
            fail(f"second_column fp32 request vs the gather form at {AUX_AB_VOXEL_CAP} voxels, "
                 f"no cap binding: {rfaults}")
        summary.update(raised_voxel_cap=AUX_AB_VOXEL_CAP, raised_stage_counts=rcounts,
                       at_raised_caps=agree)
        case = (f"a cap binds at the config's caps (differences reported: {faults or 'none'}); "
                f"with both forms at {AUX_AB_VOXEL_CAP} voxels none binds and the forms agree "
                f"({json.dumps(agree)}); stage counts there {json.dumps(rcounts)}")
        del raised
    summary["case"] = case
    log(f"[aux] fp32 A/B, second_column vs the gather form: {case}; at the config's caps "
        f"{json.dumps(full)}")
    return summary


def aux_profile(batch, step_fn, steps=2):
    """Device-busy ms of `steps` runs of step_fn(batch), after every
    host-clock reading (profile_serve.device_profile)."""
    import torch

    from dfu3d_tpu_torch.profile_serve import device_profile

    def run():
        for _ in range(steps):
            step_fn(batch)
            torch.cuda.synchronize()

    return device_profile(run, steps)[1]


def aux_demo(cfg, model, root, work, device):
    """The demo on AUX_DEMO_FILES .bin files of the root with a checkpoint
    of `model` saved and loaded as the CLI does: B1 counted, fatal unless it
    launches AUX_DEMO_B1 per file (the eval step's count on one file, also
    counted) and B2 never; PNGs rendered where matplotlib imports."""
    import numpy as np
    import torch

    from dfu3d_tpu_torch.tools import demo
    from dfu3d_tpu_torch.tools.common import build_model
    from dfu3d_tpu_torch.train.checkpoint import load_model_state
    from dfu3d_tpu_torch.train.train_state import make_eval_step

    ckpt = work / "second_column.pth"
    torch.save({"model_state": model.state_dict(), "epoch": 0, "it": 0, "optimizer_state": {},
                "version": "chip_smoke"}, ckpt)
    files = sorted((root / "velodyne").glob("*.bin"))[:AUX_DEMO_FILES]
    demo_model = build_model(cfg, "test", device)
    load_model_state(ckpt, demo_model)
    n_max, m_max = demo.frame_caps(cfg)
    first = demo.batch_of(demo.load_points(files[0]), n_max, m_max)
    make_eval_step(demo_model, device=device, dtype=torch.bfloat16)(first)   # warm-up
    torch.cuda.synchronize()
    reset_launches()
    make_eval_step(demo_model, device=device, dtype=torch.bfloat16)(first)
    per_step = read_launches()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    preds = demo.predict_files(demo_model, files, n_max, m_max, device, torch.bfloat16)
    seconds = time.perf_counter() - t0
    launches = read_launches()
    if per_step["iou_bev_overlap"] != AUX_DEMO_B1 or \
            launches["iou_bev_overlap"] != AUX_DEMO_B1 * len(files) or launches["gather_gemm"]:
        fail(f"the demo on {len(files)} files launched {launches} (its eval step on one file "
             f"{per_step}), not B1 {AUX_DEMO_B1} per file and no B2")
    kept = [len(p[1]) for p in preds]
    if not all(kept) or not all(np.isfinite(p[1]).all() for p in preds):
        fail(f"the demo's predictions: kept per file {kept}, finite "
             f"{[bool(np.isfinite(p[1]).all()) for p in preds]}")
    try:
        import matplotlib  # noqa: F401
        rendered = [str(p.relative_to(work)) for p in
                    demo.render(preds, files, cfg, work / "demo_out")]
        render = f"matplotlib imports: {len(rendered)} PNGs rendered on the host"
    except ImportError:
        rendered = []
        render = "matplotlib does not import on this machine: no PNG rendered (host drawing only)"
    log(f"[aux] demo: {render}")
    b1_entries = time_served_overlaps("demo", demo_model, first, device, names=("nms",),
                                      step=make_eval_step(demo_model, device=device,
                                                          dtype=torch.bfloat16))
    log(f"[aux] demo (tools.demo.predict_files, bf16, on the card): {len(files)} files in "
        f"{seconds * 1e3:.1f} ms, kept per file {kept}, launches {json.dumps(launches)} "
        f"(the eval step on one file: {json.dumps(per_step)})")
    return {"files": [f.name for f in files], "seconds": seconds, "kept_per_file": kept,
            "launches": launches, "eval_step_launches": per_step, "render": render,
            "pngs": rendered}, launches, b1_entries


def aux_trace(model, batches, device):
    """profiling.StepTimer over the column requests, then profiling.trace
    around one with annotate('column_request'): fatal unless the trace file
    exists and names the span and B1's CUDA kernel."""
    import torch

    from dfu3d_tpu_torch.train.train_state import make_eval_step
    from dfu3d_tpu_torch.utils import profiling

    step = make_eval_step(model, RECALL_THRESH, device=device, dtype=torch.bfloat16)
    timer = profiling.StepTimer()
    for batch in batches:
        timer.reset()
        step(batch)
        torch.cuda.synchronize()
        timer.tick("column_request")
    with tempfile.TemporaryDirectory() as d:
        with profiling.trace(d) as prof:
            with profiling.annotate("column_request"):
                step(batches[0])
                torch.cuda.synchronize()
        text = prof.trace_path.read_text()
        size = prof.trace_path.stat().st_size
    named = {"column_request": "column_request" in text, AUX_TRACE_KERNEL: AUX_TRACE_KERNEL in text}
    if not all(named.values()):
        fail(f"profiling.trace of a second_column request ({size} bytes) names {named}")
    log(f"[aux] profiling: StepTimer {timer.summary()}; trace of one column request "
        f"{size} bytes, names the span and B1's kernel ({AUX_TRACE_KERNEL})")
    return {"step_timer": timer.summary(), "trace_bytes": size, "names": named}


def aux_integrated_db(root):
    """tools.create_integrated_database on the root's gt database."""
    import pickle

    import numpy as np

    from dfu3d_tpu_torch.tools import create_integrated_database as cid

    db = root / "kitti_dbinfos_train.pkl"
    t0 = time.perf_counter()
    npy, pkl = cid.create_integrated_db(db, root)
    cid.verify(db, root, npy, pkl)
    seconds = time.perf_counter() - t0
    stacked = np.load(npy)
    with open(pkl, "rb") as f:
        clips = sum(len(v) for v in pickle.load(f).values())
    log(f"[aux] integrated gt database: {clips} clips, {len(stacked)} points in one array, "
        f"offsets verified, {seconds:.2f} s")
    return {"clips": clips, "points": int(len(stacked)), "seconds": seconds}


def aux_phase(device, card):
    """Phase 22: zoo.second_column at full width with seeded weights (the
    first request's BN statistics), bf16, on a synthetic KITTI root (8 + 4
    frames) in a temporary working directory whose cfgs/ links to
    tools/cfgs/: AUX_DEPTH requests and train steps, fatal unless each
    launches B1 as AUX_B1 says and B2 never; the gather form of the same
    weights on the same batches (its B2 launches held and timed); the fp32
    A/B (`aux_ab_check`) and the fp32 column request through B1 against its
    twin; each form's device-busy ms; the demo, the profiling trace and the
    integrated gt database. Returns (summary, launches by path, served B1
    entries, the gather leg's served B2 (totals, entries))."""
    import os

    import torch

    from dfu3d_tpu_torch import zoo
    from dfu3d_tpu_torch.core.geometry import iou_kernel
    from dfu3d_tpu_torch.flagship import calibrate_bn_, seeded_weights_
    from dfu3d_tpu_torch.models.column_sparse import ColumnVoxelBackBone8x
    from dfu3d_tpu_torch.tools.common import _voxel_processor
    from dfu3d_tpu_torch.train.train_state import make_eval_step, make_train_step

    t_phase = time.perf_counter()
    cwd = os.getcwd()
    summary = {"card": card, "config": "zoo.option_cfg('second_column') from "
               f"tools/cfgs/{zoo.OPTION_CFGS['second_column']}"}
    launches, served_b1 = {}, []
    requests, steps_n = AUX_DEPTH
    with tempfile.TemporaryDirectory() as work:
        work = Path(work)
        (work / "cfgs").mkdir()
        for sub in (REPO / "tools" / "cfgs").iterdir():
            (work / "cfgs" / sub.name).symlink_to(sub)
        os.chdir(work)
        try:
            t0 = time.perf_counter()
            root, infos = two_stage_root(work)
            summary["data_seconds"] = time.perf_counter() - t0
            cfg, grid, column = zoo.second_column(device=device)
            if type(column.backbone_3d) is not ColumnVoxelBackBone8x:
                fail(f"zoo.second_column built {type(column.backbone_3d).__name__}")
            seeded_weights_(column, seed=0)
            batches = zoo.kitti_batches(cfg, root, infos["val"], requests, 4)
            tbatches = zoo.kitti_batches(cfg, root, infos["train"], steps_n, 4, training=True)
            calibrate_bn_(column, batches[0])
            _, _, gather = aux_gather(device=device)
            gather.load_state_dict(column.state_dict())
            gather.eval()
            caps = _voxel_processor(cfg).MAX_NUMBER_OF_VOXELS
            log(f"[aux] second_column: {'x'.join(map(str, grid.grid_size))} grid, "
                f"{sum(p.numel() for p in column.parameters())} parameters, voxel caps "
                f"{caps['train']} / {caps['test']} (train / test); points per request "
                f"{[b.points_valid.sum(1).tolist() for b in batches]}")
            # 1. serving, each form on the same weights and batches
            res, launches["second_column"], serve = options_serve(
                "second_column", column, batches, device, AUX_B1[0], 0, tag="aux")
            forms = {"second_column": {"serve": serve}}
            _, launches["second_gather"], serve = options_serve(
                "second_gather", gather, batches, device, AUX_B1[0], AUX_GATHER_B2[0], tag="aux")
            forms["second_gather"] = {"serve": serve}
            # 2. training, each form from the same seeded weights on the same batches
            for name, build, b2 in (("second_column", zoo.second_column, 0),
                                    ("second_gather", aux_gather, AUX_GATHER_B2[1])):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                model, launches[f"{name}_train"], steps, state = train(name, build, tbatches,
                                                                       device)
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                bad = [s["it"] for s in steps if s["iou_bev_overlap"] != AUX_B1[1]
                       or s["gather_gemm"] != b2]
                if bad:
                    fail(f"{name} train steps {bad} did not launch B1 {AUX_B1[1]} and B2 {b2} "
                         f"times: {steps}")
                ms = [s["host_ms"] for s in steps]
                forms[name]["train"] = {
                    "batch": 4, "steps": steps, "peak_memory_gib": peak,
                    "ms_per_step": {"median_after_first": statistics.median(ms[1:] or ms),
                                    "all": ms},
                    "device": aux_profile(tbatches[0], make_train_step(
                        model, state.optimizer, device=device, dtype=torch.bfloat16))}
                del model, state
                torch.cuda.empty_cache()
            if launches["second_column"]["gather_gemm"] or \
                    launches["second_column_train"]["gather_gemm"]:
                fail(f"the column trunk launched B2: {launches}")
            # 3. device busy of a request of each form, after every host-clock reading
            for name, model in (("second_column", column), ("second_gather", gather)):
                forms[name]["serve"]["device"] = aux_profile(
                    batches[1], make_eval_step(model, RECALL_THRESH, device=device,
                                               dtype=torch.bfloat16))
            for name in forms:
                s, t = forms[name]["serve"], forms[name]["train"]
                log(f"[aux] ({card}) {name}: request median {s['request_ms']['median']:.2f} ms "
                    f"host (after the first {s['request_ms']['median_after_first']:.2f}), device "
                    f"busy {s['device'].get('device_busy_ms_per_step', float('nan')):.2f} ms, peak "
                    f"{s['peak_memory_gib']:.2f} GiB; train step median after the first "
                    f"{t['ms_per_step']['median_after_first']:.2f} ms host, device busy "
                    f"{t['device'].get('device_busy_ms_per_step', float('nan')):.2f} ms, peak "
                    f"{t['peak_memory_gib']:.2f} GiB")
            summary["forms"] = forms
            # the gather leg's served B2 calls, held and timed
            calls = record_gemm_calls(lambda: make_eval_step(
                gather, device=device, dtype=torch.bfloat16)(batches[0]))
            if len(calls) != AUX_GATHER_B2[0]:
                fail(f"one second_gather eval step made {len(calls)} gather-GEMM calls")
            gather_b2 = hold_gemm_calls("second_gather, one served request",
                                        zip(VOXEL8X_CONVS, calls))
            del calls
            served_b1 = time_served_overlaps("second_column", column, batches[0], device)
            # 4. the fp32 checks
            summary["fp32_ab"] = aux_ab_check(cfg, column, gather, batches[0], device)
            summary["fp32_b1_vs_plain"] = check_paths(
                "second_column", column, cfg, batches[0], res.preds[0],
                [(iou_kernel, "overlap_bev", "overlap_bev_plain")], device)
            del gather
            torch.cuda.empty_cache()
            # 5. the demo, the trace and the integrated gt database
            summary["demo"], launches["demo"], demo_b1 = aux_demo(cfg, column, root, work,
                                                                  device)
            served_b1 += demo_b1
            summary["profiling"] = aux_trace(column, batches, device)
            summary["integrated_db"] = aux_integrated_db(root)
        finally:
            os.chdir(cwd)
    summary["phase_seconds"] = time.perf_counter() - t_phase
    log(f"[aux] ({card}) phase 22 in {summary['phase_seconds']:.1f} s")
    return summary, launches, served_b1, gather_b2



DIST_WORLD = 2               # phase 23's ranks: gloo, both on the one card
DIST_STEPS = 2               # fp32 steps per model, world 2 against world 1
DIST_TIMED_STEPS = 4         # bf16 steps per world and model, the first a warm-up
DIST_BATCH = 4               # per rank (the flagship's BATCH_SIZE_PER_GPU); global 8
DIST_EVAL_FRAMES = 9         # val frames: odd, so the loader pads rank 1's shard
# points per eval frame: at most 30,000 pillars, so the batch's pillar cap
# (B · 32,768 over the batch in frame order) binds in no batch and each
# frame's boxes do not depend on the frames batched with it
DIST_EVAL_POINTS = (20000, 30000)
# relative: every loss term and grad_norm, world 2 vs world 1. Voxel
# CenterPoint's loc losses sum 16,384 masked |errors| per head whose inputs
# carry its trunk's rounding (DIST_SPREAD): the ranks' terms read up to
# 1.96e-5 from the one-rank terms on the card (the flagship's 6.4e-7); a
# wrong normaliser or a rank-local statistic moves a term by a factor
DIST_LOSS_TOL = 1e-4
# of a leaf's largest |entry| (a bias: its module weight's), the first
# update's summed gradient: the VFE's weights sit behind segment maxes whose
# near-ties (points within fp32 rounding of each other) two summation orders
# break either way; at the tiny grid on the CPU that moved pfn_1's BN weight
# gradient by 1.6e-4 of its scale, every other leaf by at most 5e-5
DIST_GRAD_TOL = 1e-3
DIST_PARAM_TOL = 1e-5        # of 1 + a leaf's largest |entry|, where the gradients agree to 2 %
DIST_BN_TOL = 1e-5           # of 1 + |x|, the BN running statistics
# voxel CenterPoint's check may also lie within this many times what its own
# one-rank step moves by with the batch's halves swapped: at full width and
# seeded weights its trunk's gradients are ill-conditioned, so that the swap
# alone moves a leaf by up to 0.35 % of its scale. Its fp32 runs have cuDNN
# off (`dist_cudnn`); with it on, the ranks' B=4 convs ran other algorithms
# than one process's B=8 ones and moved conv_input's kernel gradient by
# 2.67 % (5.4x the swap), with it off by 0.54 % and every check by at most
# 2.55x the swap's (python -m dfu3d_tpu_torch.parallel.rounding --shifts 3 0
# --cudnn on off and phase 23; NVIDIA H100 80GB HBM3, 700.00 W)
DIST_SPREAD = 3
DIST_BOX_TOL = 1e-4          # m and score, a frame's kept boxes, 2-rank vs 1-rank eval
DIST_AP_TOL = 1e-3
DIST_CFG = REPO / "tools" / "cfgs" / "kitti_models" / "centerpoint_nuscenes2kitti.yaml"


def dist_state(device, kind):
    """Phase 23's TrainState: the flagship ("pillar") or voxel CenterPoint
    ("voxel", its train voxel cap) at full width with seeded weights and
    every BN bias +3 (so that no ReLU input lies within fp32 rounding of 0,
    ROADMAP Queue C), the config's adam_onecycle over TRAIN_TOTAL_STEPS."""
    from dfu3d_tpu_torch.parallel.rounding import seeded_state

    return seeded_state(device, kind, 3.0, TRAIN_TOTAL_STEPS)


def dist_batches(kind, n, b, seed=0):
    """n global batches of b frames: 60,000 uniform points, 256 gt slots
    (10 columns for the voxel model's vel branch)."""
    from dfu3d_tpu_torch.parallel.rounding import global_batches

    return global_batches(kind, n, b, seed)


@contextlib.contextmanager
def dist_cudnn(kind):
    """cuDNN off for voxel CenterPoint's fp32 runs of phase 23: its
    heuristics pick the dense convs' algorithms by the batch size, so a
    rank at B=4 and one process at B=8 would run differently rounded
    convs (`parallel.rounding`); PyTorch's own conv kernels round alike
    at both sizes."""
    import torch

    enabled = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = kind != "voxel"
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = enabled


def dist_eval(rank, world, root, batch_size, device):
    """eval_one_epoch of the flagship (seeded weights, every head's boxes
    car-sized at the cars' height, fp32) over this rank's shard of the val
    split at `root`, merged over the ranks, with the test-time point shuffle
    off (np.random's global state differs between processes). Returns
    {"annos", "result", "b1": B1 launches, "frames": the shard's indices}."""
    import torch

    from dfu3d_tpu_torch.core.geometry import iou_kernel
    from dfu3d_tpu_torch.data.loader import build_dataloader
    from dfu3d_tpu_torch.flagship import seeded_weights_
    from dfu3d_tpu_torch.parallel import mesh
    from dfu3d_tpu_torch.tools.common import build_model, load_config
    from dfu3d_tpu_torch.train.eval_utils import eval_one_epoch

    class Args:
        cfg_file, set_cfgs = str(DIST_CFG), ["DATA_CONFIG.DATA_PATH", str(root)]

    cfg = load_config(Args)
    for proc in cfg.DATA_CONFIG.DATA_PROCESSOR:
        if proc.NAME == "shuffle_points":
            proc.SHUFFLE_ENABLED["test"] = False
    dataset, loader = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size=batch_size,
                                       workers=LOADER_WORKERS, training=False,
                                       process_index=rank, process_count=world)
    model = build_model(cfg, "test", device)
    seeded_weights_(model, seed=0)
    heads = model.dense_head.fused_heads
    with torch.no_grad():
        for i, (_, name, _) in enumerate(heads.branch_specs):
            at = i * heads.out_max
            if name == "center_z":
                heads.out.bias[at] = -0.9
            elif name == "dim":
                heads.out.bias[at:at + 3] = torch.log(torch.tensor([4.6, 1.9, 1.7]))
    mesh.broadcast_state_(model)
    iou_kernel.launches = 0
    _, result, annos = eval_one_epoch(model, dataset, loader, cfg, None, device=device)
    return {"annos": annos, "result": result, "b1": iou_kernel.launches,
            "frames": [int(i) for i in loader._local_indices()]}


def dist_rank(rank, world, root, device):
    """Phase 23 on one rank of a gloo group sharing the card: DIST_STEPS
    fp32 steps of each model (its summed gradients kept), DIST_TIMED_STEPS
    timed bf16 steps, then the eval epoch."""
    import functools

    import torch

    from dfu3d_tpu_torch.parallel.launch import train_rank

    torch.backends.cudnn.allow_tf32 = False    # as the parent: fp32 is fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for kind in ("pillar", "voxel"):
        build = functools.partial(dist_state, kind=kind)
        with dist_cudnn(kind):
            out[kind] = train_rank(rank, world, build,
                                   dist_batches(kind, DIST_STEPS, world * DIST_BATCH),
                                   device=device, dtype=torch.float32, keep_grads=rank == 0)
        out[f"{kind}_bf16"] = train_rank(
            rank, world, build, dist_batches(kind, DIST_TIMED_STEPS, world * DIST_BATCH, seed=10),
            device=device, dtype=torch.bfloat16)
        del out[f"{kind}_bf16"]["state"]
        torch.cuda.empty_cache()
    out["eval"] = dist_eval(rank, world, root, DIST_BATCH, device)
    return out


def dist_compare(kind, got, want, lr, reordered=None):
    """A rank's fp32 run against the world-1 run on the joined batches: the
    metrics of every step within DIST_LOSS_TOL relative; the first update's
    summed gradients within DIST_GRAD_TOL of each leaf's largest entry (a
    bias: of its module weight's, where rounding noise is all there is);
    the BN statistics within DIST_BN_TOL; the parameters within
    DIST_PARAM_TOL where every update's gradients agree to 2 %, else within
    2 lr per update (Adam moves a noise-sized gradient's entry by about lr).
    With `reordered`, the world-1 run on the same batches with the ranks'
    halves swapped (the same function summed in another order: the
    ranks' sums are that too), a metric, a gradient leaf or a BN leaf may
    also lie within DIST_SPREAD times the two world-1 runs' difference.
    Returns the largest errors and spreads and the largest multiple of the
    spread a check past its base tolerance needed; fails after listing
    every disagreement."""
    import numpy as np

    from dfu3d_tpu_torch.parallel.rounding import leaf_scale

    worst = {"loss_rel": 0.0, "grad_of_scale": 0.0, "bn": 0.0, "param_sure": 0.0,
             "param_unsure": 0.0, "unsure_entries": 0, "widened": 0,
             "spread_loss_rel": 0.0, "spread_grad_of_scale": 0.0, "spread_bn": 0.0,
             "spread_needed": 0.0}

    def widen(err, base, spread):
        # the multiple of the reordered run's spread a check past its base
        # tolerance needs
        if err > base:
            worst["spread_needed"] = max(worst["spread_needed"],
                                         err / spread if spread else math.inf)
            worst["widened"] += int(err <= DIST_SPREAD * spread)
        return err > max(base, DIST_SPREAD * spread)

    bad = []
    for step, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
        for k in w:
            rel = abs(g[k] - w[k]) / max(abs(w[k]), 1e-30)
            spread = (abs(reordered["metrics"][step][k] - w[k]) / max(abs(w[k]), 1e-30)
                      if reordered else 0.0)
            worst["loss_rel"] = max(worst["loss_rel"], rel)
            worst["spread_loss_rel"] = max(worst["spread_loss_rel"], spread)
            if widen(rel, DIST_LOSS_TOL, spread):
                bad.append(f"step {step} {k} {g[k]} on {DIST_WORLD} ranks, {w[k]} on one "
                           f"(relative {rel:.3g}; the reordered run {spread:.3g})")
    sure = {}
    for step, (gg, wg) in enumerate(zip(got["grads"], want["grads"])):
        for k, w in wg.items():
            agree = np.abs(gg[k] - w) <= 0.02 * np.abs(w)
            sure[k] = sure.get(k, agree) & agree
            if step:
                continue
            scale = leaf_scale(wg, k)
            err = float(np.abs(gg[k] - w).max()) / scale
            spread = (float(np.abs(reordered["grads"][0][k] - w).max()) / scale
                      if reordered else 0.0)
            worst["grad_of_scale"] = max(worst["grad_of_scale"], err)
            worst["spread_grad_of_scale"] = max(worst["spread_grad_of_scale"], spread)
            if widen(err, DIST_GRAD_TOL, spread):
                bad.append(f"the summed gradient of {k} is {err:.3g} of its scale from the "
                           f"one-rank gradient (the reordered run {spread:.3g})")
    steps = len(got["grads"])
    for k, w in want["state"].items():
        g = got["state"][k]
        leaf = k.rsplit(".", 1)[1]
        if leaf in ("running_mean", "running_var"):
            err = float((np.abs(g - w) / (1 + np.abs(w))).max())
            spread = (float((np.abs(reordered["state"][k] - w) / (1 + np.abs(w))).max())
                      if reordered else 0.0)
            worst["bn"] = max(worst["bn"], err)
            worst["spread_bn"] = max(worst["spread_bn"], spread)
            if widen(err, DIST_BN_TOL, spread):
                bad.append(f"BN statistic {k} off by {err:.3g} of 1 + |x| (the reordered run "
                           f"{spread:.3g})")
            continue
        tol = DIST_PARAM_TOL * (1 + np.abs(w).max())
        s = sure.get(k, np.ones(w.shape, bool))
        d = np.abs(g - w)
        worst["unsure_entries"] += int((~s).sum())
        if s.any():
            worst["param_sure"] = max(worst["param_sure"], float(d[s].max()))
        if (~s).any():
            worst["param_unsure"] = max(worst["param_unsure"], float(d[~s].max()))
        if (s.any() and d[s].max() > tol) or ((~s).any() and d[~s].max() > 2 * lr * steps + tol):
            bad.append(f"parameter {k} off by {d.max():.3g} after {steps} steps")
    if bad:
        fail(f"phase 23 {kind}, {len(bad)} disagreements (worst {worst}): " + "; ".join(bad[:20]))
    return worst


def distributed_phase(device, card):
    """Phase 23: the data-parallel path on the one card. (a) the flagship's
    fp32 steps in a world-1 NCCL group (the production init and backend:
    broadcast, gradient all-reduce, metric all-reduce) equal the steps
    without a group bit for bit, and (d) `make_multi_train_step` with K=2
    equals two single steps bit for bit; (b) DIST_WORLD spawned ranks over
    gloo, both on the card, train the flagship and voxel CenterPoint
    DIST_STEPS fp32 steps on their rows of each global batch of
    DIST_WORLD · DIST_BATCH, held against the world-1 run on the joined
    batches (`dist_compare`; voxel CenterPoint's fp32 runs with cuDNN off,
    and also against the world-1 run with the halves swapped), their states
    equal bit for bit, B2 41 times
    per voxel step on each rank; timed bf16 steps of both worlds; (c) the
    2-rank eval epoch over an odd-sized synthetic KITTI val split against
    the 1-rank one (kept boxes, AP, the padded duplicate), B1 twice per eval
    step on each rank. Returns (summary, launches by path)."""
    import functools

    import numpy as np
    import torch

    from dfu3d_tpu_torch.data import kitti_synthetic
    from dfu3d_tpu_torch.parallel import destroy_distributed, init_distributed, mesh
    from dfu3d_tpu_torch.parallel.launch import run_ranks, to_host, train_rank
    from dfu3d_tpu_torch.parallel.rounding import swap_halves
    from dfu3d_tpu_torch.tools import create_infos
    from dfu3d_tpu_torch.train.eval_utils import first_copies
    from dfu3d_tpu_torch.train.train_state import make_multi_train_step, make_train_step

    t_phase = time.perf_counter()
    summary = {"card": card, "world": DIST_WORLD, "batch_per_rank": DIST_BATCH}
    launches = {}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        work = Path(work)

        # (a) and (d), in this process
        batches = dist_batches("pillar", 2, DIST_BATCH, seed=20)
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True

        def two_steps(k):
            state = dist_state(device, "pillar")
            mesh.broadcast_state_(state.model)
            if k == 1:
                step = make_train_step(state.model, state.optimizer, device=device,
                                       dtype=torch.float32)
                metrics = [step(b) for b in batches]
            else:
                metrics = [make_multi_train_step(state.model, state.optimizer, k, device=device,
                                                 dtype=torch.float32)(batches)]
            return ({n: v.detach().clone() for n, v in state.model.state_dict().items()},
                    [{n: v.tolist() for n, v in m.items()} for m in metrics])

        try:
            plain, m_plain = two_steps(1)
            multi, m_multi = two_steps(2)
            init_distributed("cuda", backend="nccl", init_method=f"file://{work}/nccl_store",
                             rank=0, world_size=1)
            try:
                backend = torch.distributed.get_backend()
                nccl, m_nccl = two_steps(1)
            finally:
                destroy_distributed()
        finally:
            torch.backends.cudnn.deterministic = deterministic
        for tag, other in (("world-1 NCCL", nccl), ("steps_per_dispatch 2", multi)):
            bad = [k for k in plain if not torch.equal(plain[k], other[k])]
            if bad:
                fail(f"phase 23: the flagship's fp32 steps with {tag} differ from the plain steps "
                     f"at {len(bad)} tensors, e.g. {bad[:4]}")
        if m_nccl != m_plain:
            fail(f"phase 23: world-1 NCCL metrics {m_nccl} differ from {m_plain}")
        (mk,) = m_multi
        if (mk["loss_steps"] != [m["loss"] for m in m_plain]
                or {k: v for k, v in mk.items() if k != "loss_steps"} != m_plain[-1]):
            fail(f"phase 23: the K=2 metrics {mk} are not the single steps' {m_plain}")
        summary["nccl_world1_and_k2"] = {"backend": backend, "tensors": len(plain),
                                         "bit_equal": True, "losses": mk["loss_steps"]}
        log(f"[dist] (a) the flagship's 2 fp32 steps in a world-1 {backend} group and (d) as one "
            f"steps_per_dispatch-2 call equal the plain steps bit for bit ({len(plain)} tensors; "
            f"losses {mk['loss_steps']})")
        del plain, multi, nccl
        torch.cuda.empty_cache()

        # (c)'s root, written before the ranks start
        root = work / "train_28130"
        kitti_synthetic.write_root(root, 0, DIST_EVAL_FRAMES, ["Car", "Pedestrian"], seed=23,
                                   num_points=DIST_EVAL_POINTS, near_cars=3)
        (out,) = create_infos.main(["--cfg_file", str(DIST_CFG), "--data_path", str(root),
                                    "--splits", "val", "--no_gt_database"])["infos"]
        (work / "val_6019").mkdir()
        out.rename(work / "val_6019" / "nuscenes2kitti_infos_val_6019.pkl")

        # (b) and (c)'s world-1 references on the joined batches, this process
        one = {}
        for kind in ("pillar", "voxel"):
            build = functools.partial(dist_state, kind=kind)
            joined = dist_batches(kind, DIST_STEPS, DIST_WORLD * DIST_BATCH)
            with dist_cudnn(kind):
                one[kind] = to_host(train_rank(0, 1, build, joined, device=device,
                                               dtype=torch.float32, keep_grads=True))
                if kind == "voxel":
                    # the same batches with the ranks' halves swapped: the
                    # same function (the voxel caps are per frame), summed
                    # in another order. The pillar cap is the batch's, in
                    # frame order, and binds on these frames: there a swap
                    # is another function
                    one[f"{kind}_reordered"] = to_host(train_rank(
                        0, 1, build, swap_halves(joined, DIST_BATCH), device=device,
                        dtype=torch.float32, keep_grads=True))
            one[f"{kind}_bf16"] = to_host(train_rank(
                0, 1, build, dist_batches(kind, DIST_TIMED_STEPS, DIST_WORLD * DIST_BATCH,
                                          seed=10), device=device, dtype=torch.bfloat16))
            torch.cuda.empty_cache()
        one["eval"] = to_host(dist_eval(0, 1, root, DIST_BATCH, device))
        t_ranks = time.perf_counter()
        ranks = run_ranks(dist_rank, DIST_WORLD, args=(str(root), str(device)),
                          device=str(device), backend="gloo", timeout_s=600)
        ranks_s = time.perf_counter() - t_ranks

    # (b)
    lr0 = dist_state("cpu", "pillar").optimizer.lr_fn(0)
    for kind in ("pillar", "voxel"):
        want = one[kind]
        worst = dist_compare(kind, ranks[0][kind], want, lr0, one.get(f"{kind}_reordered"))
        for r in ranks[1:]:
            bad = [k for k in r[kind]["state"]
                   if not np.array_equal(r[kind]["state"][k], ranks[0][kind]["state"][k])]
            if bad:
                fail(f"phase 23 {kind}: the ranks' states differ at {bad[:4]}")
        b2_want = VOXEL_TRAIN_B2 if kind == "voxel" else 0
        for r, got in enumerate(ranks):
            for tag in (kind, f"{kind}_bf16"):
                counts = got[tag]["launches"]
                if any(b1 or b2 != b2_want for b1, b2 in counts):
                    fail(f"phase 23 {tag}: rank {r}'s steps launched (B1, B2) {counts}, not "
                         f"(0, {b2_want}) each")
        launches[f"dist_{kind}"] = {
            "iou_bev_overlap": 0,
            "gather_gemm": sum(b2 for got in ranks for tag in (kind, f"{kind}_bf16")
                               for _, b2 in got[tag]["launches"]),
            "world1_gather_gemm": sum(b2 for tag in (kind, f"{kind}_bf16", f"{kind}_reordered")
                                      if tag in one for _, b2 in one[tag]["launches"])}
        timed = {w: [statistics.median(r[f"{kind}_bf16"]["ms"][1:]) for r in rs]
                 for w, rs in (("world2", ranks), ("world1", [one]))}
        summary[kind] = {
            "fp32_worst": worst,
            "losses": [m["loss"] for m in ranks[0][kind]["metrics"]],
            "grad_norms": [m["grad_norm"] for m in ranks[0][kind]["metrics"]],
            "b2_per_step_per_rank": [[b2 for _, b2 in got[kind]["launches"]] for got in ranks],
            "bf16_step_ms": {"world2_per_rank": timed["world2"],
                             "world1_global_batch": timed["world1"][0],
                             "world2_all": [r[f"{kind}_bf16"]["ms"] for r in ranks],
                             "world1_all": one[f"{kind}_bf16"]["ms"]},
            "peak_gib": {"world2_per_rank": [r[f"{kind}_bf16"]["peak_gib"] for r in ranks],
                         "world2_fp32_per_rank": [r[kind]["peak_gib"] for r in ranks],
                         "world1": one[f"{kind}_bf16"]["peak_gib"],
                         "world1_fp32": one[kind]["peak_gib"]}}
        log(f"[dist] (b) ({card}) {kind}: {DIST_WORLD} gloo ranks x B={DIST_BATCH} vs world 1 x "
            f"B={DIST_WORLD * DIST_BATCH}, {DIST_STEPS} fp32 steps: losses "
            f"{summary[kind]['losses']}, worst loss term {worst['loss_rel']:.3g} rel, first "
            f"gradient {worst['grad_of_scale']:.3g} of scale, BN {worst['bn']:.3g}, parameters "
            f"{worst['param_sure']:.3g} ({worst['unsure_entries']} entries held to 2 lr per step, "
            f"worst {worst['param_unsure']:.3g}); one rank against itself with the halves "
            f"swapped: loss {worst['spread_loss_rel']:.3g}, gradient "
            f"{worst['spread_grad_of_scale']:.3g}, BN {worst['spread_bn']:.3g} "
            f"({worst['widened']} checks within {DIST_SPREAD}x that and not within the base "
            f"tolerance, needing at most {worst['spread_needed']:.3g}x); "
            f"ranks bit-equal; B2 per step per rank {summary[kind]['b2_per_step_per_rank']}")
        log(f"[dist] (b) ({card}) {kind} bf16 step, median of {DIST_TIMED_STEPS - 1} after a "
            f"warm-up: {DIST_WORLD} ranks sharing the card {timed['world2']} ms (each rank "
            f"B={DIST_BATCH}), world 1 at B={DIST_WORLD * DIST_BATCH} {timed['world1'][0]:.2f} ms; "
            f"peak per rank {summary[kind]['peak_gib']['world2_per_rank']} GiB, world 1 "
            f"{summary[kind]['peak_gib']['world1']:.2f} GiB")

    # (c)
    want = one["eval"]
    ids = [a["frame_id"] for a in want["annos"]]
    first = sorted(set(ranks[0]["eval"]["frames"]) & set(ranks[1]["eval"]["frames"]))
    for r, got in enumerate(ranks):
        res, annos = got["eval"]["result"], got["eval"]["annos"]
        got_ids = [a["frame_id"] for a in annos]
        if got_ids != sorted(ids + [ids[i] for i in first], key=ids.index):
            fail(f"phase 23 (c): rank {r}'s merged frames {got_ids} are not {ids} with the padded "
                 f"duplicate of frame index {first}")
        if res["num_frames"] != len(ids) + len(first):
            fail(f"phase 23 (c): num_frames {res['num_frames']}")
        worst_box = 0.0
        for g, w in zip(first_copies(annos), want["annos"]):
            rows_g = np.concatenate([g["boxes_lidar"], g["score"][:, None]], 1)
            rows_w = np.concatenate([w["boxes_lidar"], w["score"][:, None]], 1)
            if len(rows_g) != len(rows_w):
                fail(f"phase 23 (c): frame {w['frame_id']} keeps {len(rows_g)} boxes on "
                     f"{DIST_WORLD} ranks, {len(rows_w)} on one")
            if len(rows_w):
                dist = np.abs(rows_g[:, None] - rows_w[None]).max(-1)
                worst_box = max(worst_box, float(dist.min(0).max()))
        if worst_box > DIST_BOX_TOL:
            fail(f"phase 23 (c): a kept box moved {worst_box:.3g} between the evals")
        ap = {k: (res[k], want["result"][k]) for k in want["result"] if "_R40" in k}
        off = {k: v for k, v in ap.items() if abs(v[0] - v[1]) > DIST_AP_TOL}
        if not ap or off:
            fail(f"phase 23 (c): AP differs {off}")
        batches = res["eval_batches"]
        if got["eval"]["b1"] != 2 * batches:
            fail(f"phase 23 (c): rank {r} launched B1 {got['eval']['b1']} times in {batches} "
                 "eval steps, not 2 per step")
    if want["b1"] != 2 * want["result"]["eval_batches"]:
        fail(f"phase 23 (c): the 1-rank eval launched B1 {want['b1']} times")
    car = "Car_3d/moderate_R40"
    summary["eval"] = {"frames": len(ids), "merged_frames": len(ids) + len(first),
                       "padded_duplicate": [ids[i] for i in first], "worst_box": worst_box,
                       "ap": {k: v for k, v in ap.items() if k.startswith("Car")},
                       "b1_per_rank": [got["eval"]["b1"] for got in ranks],
                       "eval_batches_per_rank": [got["eval"]["result"]["eval_batches"]
                                                 for got in ranks]}
    launches["dist_eval"] = {"iou_bev_overlap": sum(got["eval"]["b1"] for got in ranks),
                             "gather_gemm": 0, "world1_iou_bev_overlap": want["b1"]}
    log(f"[dist] (c) ({card}) eval of {len(ids)} frames on {DIST_WORLD} ranks (shards "
        f"{[got['eval']['frames'] for got in ranks]}): merged {len(ids) + len(first)} annos with "
        f"the padded duplicate {summary['eval']['padded_duplicate']}; kept boxes within "
        f"{worst_box:.3g} of the 1-rank eval, {car} {ap.get(car)}; B1 "
        f"{summary['eval']['b1_per_rank']} launches in {summary['eval']['eval_batches_per_rank']} "
        f"eval steps per rank")
    summary["ranks_seconds"] = ranks_s
    summary["seconds"] = time.perf_counter() - t_phase
    log(f"[dist] phase 23: {summary['seconds']:.1f} s, the ranks' call {ranks_s:.1f} s")
    return summary, launches


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

    clock = {"t": time.perf_counter()}

    def lap(name):   # host seconds of each phase, logged as it ends
        now = time.perf_counter()
        log(f"[time] {name}: {now - clock['t']:.1f} s")
        clock["t"] = now

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

    lap("phases 1-6")
    # 7. the flagship from disk through the CLIs
    pillar_step_ms = statistics.median(s["host_ms"] for s in pillar_steps)
    cli_summary, cli_train, cli_eval = cli(device, pillar_step_ms)

    lap("phase 7")
    # 8. pipeline 2: depth completion and the pseudo-box factory through their CLIs
    pseudo_summary, pseudo_launches = pseudo(device)

    lap("phase 8")
    # 9. pipelines 1 and 4: nuScenes -> KITTI, self-evolution, the synthetic run
    evolve_summary, evolve_launches, v8_served, v8_dx = evolve_phase(device)
    ev_iou = sum(v["iou_bev_overlap"] for v in evolve_launches.values())

    lap("phase 9")
    # 10. PointRCNN serving, in memory and through tools.test
    prcnn_summary, prcnn_launches, prcnn_cli_launches, prcnn_served = pointrcnn_phase(device,
                                                                                      card)
    served_iou += prcnn_served
    prcnn_nms = prcnn_served[0]

    lap("phase 10")
    # 11. PointRCNN training, in memory and through tools.train / tools.test
    (prcnn_train_summary, prcnn_train, prcnn_cli_train, prcnn_cli_train_eval, prcnn_train_b1,
     prcnn_evolve) = pointrcnn_train_phase(device, card)

    lap("phase 11")
    # 12. depth-completion training, then pipeline 2 from the trained weights
    depth_summary, depth_launches = depth_train_phase(device, card)
    depth_b1 = sum(v["iou_bev_overlap"] for v in depth_launches.values())
    depth_b2 = sum(v["gather_gemm"] for v in depth_launches.values())

    lap("phase 12")
    # 13. nuScenes from disk and the anchor detectors (SECOND, PointPillar multi-head)
    nusc_summary, nusc_launches, nusc_iou, nusc_served_b2, nusc_dx = nuscenes_phase(device, card)
    served_iou += nusc_iou
    nusc_b1 = sum(v["iou_bev_overlap"] for v in nusc_launches.values())
    nusc_b2 = sum(v["gather_gemm"] for v in nusc_launches.values())

    lap("phase 13")
    # 14. the two-stage voxel detectors (SECOND-IoU, Voxel R-CNN, PV-RCNN, PartA2,
    # PV-RCNN++) on KITTI
    two_summary, two_launches, two_b1_served, two_b1_train, two_b2 = two_stage_phase(device,
                                                                                   card)
    served_iou += two_b1_served
    two_b1 = sum(v["iou_bev_overlap"] for v in two_launches.values())
    two_b2_n = sum(v["gather_gemm"] for v in two_launches.values())

    lap("phase 14")
    # 15. the fully sparse and pillar-sparse detectors (VoxelNeXt on nuScenes, its
    # double flip and the large Waymo config; PillarNet on KITTI and Waymo)
    fs_summary, fs_launches, fs_b1_served, fs_b2 = fully_sparse_phase(device, card)
    served_iou += fs_b1_served
    fs_b1 = sum(v["iou_bev_overlap"] for v in fs_launches.values())
    fs_b2_n = sum(v["gather_gemm"] for v in fs_launches.values())
    fs_wide = [dict(e, model=name, path=path) for name, by in fs_b2.items()
               for path, (_, entries) in by.items() for e in entries
               if max(e["shape"][2][1:]) == 256 or e["shape"][2][0] == 125]

    lap("phase 15")
    # 16. TransFusion-L on nuScenes (the recall through B1, the trunk through B2)
    tf_summary, tf_launches, tf_b1_served, tf_b2 = transfusion_phase(device, card)
    served_iou += tf_b1_served
    tf_b1 = sum(v["iou_bev_overlap"] for v in tf_launches.values())
    tf_b2_n = sum(v["gather_gemm"] for v in tf_launches.values())

    lap("phase 16")
    # 17. DSVT-Pillar and DSVT-Voxel on the Waymo DSVT configs (B1 only)
    ds_summary, ds_launches, ds_b1_served = dsvt_phase(device, card)
    served_iou += ds_b1_served
    ds_b1 = sum(v["iou_bev_overlap"] for v in ds_launches.values())
    ds_b2 = sum(v["gather_gemm"] for v in ds_launches.values())
    if ds_b2:
        fail(f"the DSVT paths launched B2 {ds_b2} times: {ds_launches}")

    lap("phase 17")
    # 18. MPPNet (4 and 16 frames) and MPPNetE2E on the Waymo MPPNet configs
    mp_summary, mp_launches, mp_b1_served, mp_b1_train, mp_b2 = mppnet_phase(device, card)
    served_iou += mp_b1_served
    mp_b1 = sum(v["iou_bev_overlap"] for v in mp_launches.values())
    mp_b2_n = sum(v["gather_gemm"] for v in mp_launches.values())

    lap("phase 18")
    # 19. the camera detectors (BEVFusion, CaDDN, the focal multimodal Voxel R-CNN)
    cam_summary, cam_launches, cam_b1_served, cam_b2 = camera_phase(device, card)
    served_iou += cam_b1_served
    cam_b1 = sum(v["iou_bev_overlap"] for v in cam_launches.values())
    cam_b2_n = sum(v["gather_gemm"] for v in cam_launches.values())

    lap("phase 19")
    # 20. the other lidar datasets from disk through the CLIs (Waymo and ONCE
    # CenterPoint trained and tested, Lyft, Custom and Argo2 tested)
    dset_summary, dset_launches, dset_b1_served, dset_b2 = datasets_phase(device, card)
    served_iou += dset_b1_served
    dset_b1 = sum(v["iou_bev_overlap"] for v in dset_launches.values())
    dset_b2_n = sum(v["gather_gemm"] for v in dset_launches.values())

    lap("phase 20")
    # 21. the model options and legacy compact schemas on the configs derived
    # from shipped ones (zoo.option_cfg), and the KITTI image data path
    opt_summary, opt_launches, opt_b1_train, opt_b2 = options_phase(device, card)
    opt_b1 = sum(v["iou_bev_overlap"] for v in opt_launches.values())
    opt_b2_n = sum(v["gather_gemm"] for v in opt_launches.values())

    lap("phase 21")
    # 22. the column formulation of VoxelBackBone8x (second_column) and its A/B
    # against the gather form; the demo, the profiling trace, the integrated gt database
    aux_summary, aux_launches, aux_b1_served, aux_b2 = aux_phase(device, card)
    served_iou += aux_b1_served
    aux_b1 = sum(v["iou_bev_overlap"] for v in aux_launches.values())
    aux_b2_n = sum(v["gather_gemm"] for v in aux_launches.values())

    lap("phase 22")
    # 23. data parallelism: world-1 NCCL and K=2 bit for bit, two gloo ranks
    # sharing the card against one rank on the joined batch, the 2-rank eval
    dist_summary, dist_launches = distributed_phase(device, card)
    dist_b1 = sum(v["iou_bev_overlap"] for v in dist_launches.values())
    dist_b2 = sum(v["gather_gemm"] for v in dist_launches.values())

    lap("phase 23")
    # the device profiles of phase 19 (DEVICE_PROFILED) and phase 13's
    # profile_* subprocesses, after every host-clock reading
    run_deferred_profiles()
    for name in CAMERA_MODELS:
        for key in ("serve", "train"):
            part = cam_summary[name][key]
            prof = part["profile"]
            busy = prof["device_time"].get("device_busy_ms_per_step")
            host = (part["request_ms"]["median"] if key == "serve"
                    else part["ms_per_step"]["median"])
            part["device_busy_ms"] = busy
            log(f"[camera] ({card}) {name} {key}: host {host:.2f} ms per "
                f"{'request' if key == 'serve' else 'step'}, device busy "
                f"{busy if busy is not None else float('nan'):.2f} ms, idle share of the "
                f"profiled window {prof['device_time'].get('device_idle_share', float('nan')):.3f}"
                f", of the host time {1 - busy / host if busy is not None else float('nan'):.3f}; "
                f"peak memory {part['peak_memory_gib']:.2f} GiB")
    for name in MPPNET_DEPTH:
        for key in ("serve", "train"):
            part = mp_summary[name][key]
            prof = part["profile"]
            busy = prof["device_time"].get("device_busy_ms_per_step")
            host = (part["request_ms"]["median"] if key == "serve"
                    else part["ms_per_step"]["median"])
            log(f"[mppnet] ({card}) {name} {key}: host {host:.2f} ms per "
                f"{'request' if key == 'serve' else 'step'}, device busy "
                f"{busy if busy is not None else float('nan'):.2f} ms, idle share of the "
                f"profiled window {prof['device_time'].get('device_idle_share', float('nan')):.3f}"
                f", of the host time {1 - busy / host if busy is not None else float('nan'):.3f}; "
                f"peak memory {part['peak_memory_gib']:.2f} GiB")
    for name in DSVT_DEPTH:
        for key in ("serve", "train"):
            part = ds_summary[name][key]
            prof = part["profile"]
            busy = prof["device_time"].get("device_busy_ms_per_step")
            host = (part["request_ms"]["median"] if key == "serve"
                    else part["ms_per_step"]["median"])
            log(f"[dsvt] ({card}) {name} {key}: host {host:.2f} ms per "
                f"{'request' if key == 'serve' else 'step'}, device busy "
                f"{busy if busy is not None else float('nan'):.2f} ms, idle share of the "
                f"profiled window {prof['device_time'].get('device_idle_share', float('nan')):.3f}"
                f", of the host time {1 - busy / host if busy is not None else float('nan'):.3f}; "
                f"peak memory {part['peak_memory_gib']:.2f} GiB; share of each frame's voxels in "
                f"a set by layer {[[round(v, 4) for v in row] for row in prof['set_shares']]}")
    for key in ("serve", "train"):
        prof = tf_summary[key]["profile"]
        busy = prof["device_time"].get("device_busy_ms_per_step")
        host = (tf_summary["serve"]["request_ms"]["median"] if key == "serve"
                else tf_summary["train"]["ms_per_step"]["median"])
        log(f"[transfusion] ({card}) {key}: host {host:.2f} ms per "
            f"{'request' if key == 'serve' else 'step'}, device busy "
            f"{busy if busy is not None else float('nan'):.2f} ms, idle share of the profiled "
            f"window {prof['device_time'].get('device_idle_share', float('nan')):.3f}, of the "
            f"host time {1 - busy / host if busy is not None else float('nan'):.3f}; peak memory "
            f"{tf_summary[key]['peak_memory_gib']:.2f} GiB")
    lap("deferred device profiles")
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
                     + prcnn_evolve["iou_bev_overlap"] + depth_b1 + nusc_b1 + two_b1 + fs_b1
                     + tf_b1 + ds_b1 + mp_b1 + cam_b1 + dset_b1 + opt_b1 + aux_b1 + dist_b1),
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
                                for k, v in two_launches.items()},
                             **{f"fully_sparse_{k}": v["iou_bev_overlap"]
                                for k, v in fs_launches.items()},
                             **{k: v["iou_bev_overlap"] for k, v in tf_launches.items()},
                             **{k: v["iou_bev_overlap"] for k, v in ds_launches.items()},
                             **{k: v["iou_bev_overlap"] for k, v in mp_launches.items()},
                             **{f"camera_{k}": v["iou_bev_overlap"]
                                for k, v in cam_launches.items()},
                             **{f"datasets_{k}": v["iou_bev_overlap"]
                                for k, v in dset_launches.items()},
                             **{f"options_{k}": v["iou_bev_overlap"]
                                for k, v in opt_launches.items()},
                             **{f"aux_{k}": v["iou_bev_overlap"]
                                for k, v in aux_launches.items()},
                             **{f"{k}_per_rank_sum": v["iou_bev_overlap"]
                                for k, v in dist_launches.items()}},
        "train_launches_per_step": {"pointrcnn": sorted(
            {st["iou_bev_overlap"] for st in prcnn_train_summary["steps"]}),
            "second": sorted({st["iou_bev_overlap"]
                              for st in nusc_summary["second_train"]["steps"]}),
            **{name: sorted({st["iou_bev_overlap"] for st in two_summary[name]["train"]["steps"]})
               for name in TWO_STAGE_CONVS},
            "transfusion": sorted({st["iou_bev_overlap"]
                                   for st in tf_summary["train"]["steps"]}),
            **{name: sorted({st["iou_bev_overlap"] for st in ds_summary[name]["train"]["steps"]})
               for name in DSVT_DEPTH},
            **{name: sorted({st["iou_bev_overlap"] for st in mp_summary[name]["train"]["steps"]})
               for name in MPPNET_DEPTH},
            **{name: sorted({st["iou_bev_overlap"] for st in cam_summary[name]["train"]["steps"]})
               for name in CAMERA_MODELS},
            **{f"{tag}_cli": [dset_launches[f"{tag}_cli_train"]["iou_bev_overlap"]]
               for tag in ("waymo", "once")},
            **{name: sorted({st["iou_bev_overlap"] for st in opt_summary[name]["train"]["steps"]})
               for name in OPTIONS_DEPTH},
            **{name: sorted({st["iou_bev_overlap"]
                             for st in aux_summary["forms"][name]["train"]["steps"]})
               for name in aux_summary["forms"]}},
        "max_abs_err": max([iou_err] + [e["max_abs_err"]
                                        for e in served_iou + prcnn_train_b1 + two_b1_train
                                        + mp_b1_train + opt_b1_train]),
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
        "shapes": [e["shape"] for e in iou_shapes + served_iou + prcnn_train_b1 + opt_b1_train],
        "per_shape": iou_shapes,
        "served": served_iou,
        "pointrcnn_train": prcnn_train_b1,
        "pointrcnn_proposal_nms": {k: prcnn_nms[k] for k in (
            "shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "ops", "bytes",
            "survivor_share", "overlapping_share", "share_of_bound", "bound_all_pairs_ms")},
        "two_stage_train": two_b1_train,
        "mppnet_train": mp_b1_train,
        "camera_served": [{k: e[k] for k in ("path", "problem", "shape", "max_abs_err", "ms",
                                             "plain_ms", "bound_ms", "bound_by")}
                          for e in cam_b1_served],
        "datasets_served": [{k: e[k] for k in ("path", "problem", "shape", "max_abs_err", "ms",
                                               "plain_ms", "bound_ms", "bound_by")}
                            for e in dset_b1_served],
        "options_train": [{k: e[k] for k in ("path", "problem", "shape", "max_abs_err", "ms",
                                             "plain_ms", "bound_ms", "bound_by")}
                          for e in opt_b1_train],
        "aux_served": [{k: e[k] for k in ("path", "problem", "shape", "max_abs_err", "ms",
                                          "plain_ms", "bound_ms", "bound_by")}
                       for e in aux_b1_served],
    }, {
        "name": "gather_gemm",
        "route": "cuda",
        "source": "dfu3d_tpu_torch/core/voxel/csrc/gather_gemm.cu",
        "replaces": "dfu3d_tpu/core/voxel/pallas_sparse.py:77",
        "launches": (voxel_launches["gather_gemm"] + voxel_train["gather_gemm"]
                     + sum(v["gather_gemm"] for v in evolve_launches.values())
                     + prcnn_evolve["gather_gemm"] + depth_b2 + nusc_b2 + two_b2_n + fs_b2_n
                     + tf_b2_n + ds_b2 + mp_b2_n + cam_b2_n + dset_b2_n + opt_b2_n
                     + aux_b2_n + dist_b2),
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
                                for k, v in two_launches.items()},
                             **{f"fully_sparse_{k}": v["gather_gemm"]
                                for k, v in fs_launches.items()},
                             **{k: v["gather_gemm"] for k, v in tf_launches.items()},
                             **{k: v["gather_gemm"] for k, v in ds_launches.items()},
                             **{k: v["gather_gemm"] for k, v in mp_launches.items()},
                             **{f"camera_{k}": v["gather_gemm"] for k, v in cam_launches.items()},
                             **{f"datasets_{k}": v["gather_gemm"]
                                for k, v in dset_launches.items()},
                             **{f"options_{k}": v["gather_gemm"]
                                for k, v in opt_launches.items()},
                             **{f"aux_{k}": v["gather_gemm"] for k, v in aux_launches.items()},
                             **{f"{k}_per_rank_sum": v["gather_gemm"]
                                for k, v in dist_launches.items()}},
        "launches_by_variant": {k: voxel_launches[f"gather_gemm_{k}"]
                                + voxel_train[f"gather_gemm_{k}"]
                                + sum(v[f"gather_gemm_{k}"] for v in evolve_launches.values())
                                + sum(v[f"gather_gemm_{k}"] for v in nusc_launches.values())
                                + sum(v[f"gather_gemm_{k}"] for v in two_launches.values())
                                + sum(v[f"gather_gemm_{k}"] for v in fs_launches.values())
                                + sum(v[f"gather_gemm_{k}"] for v in tf_launches.values())
                                + sum(v[f"gather_gemm_{k}"] for v in ds_launches.values())
                                + sum(v[f"gather_gemm_{k}"] for v in mp_launches.values())
                                + sum(v[f"gather_gemm_{k}"] for v in cam_launches.values())
                                + sum(v[f"gather_gemm_{k}"] for v in dset_launches.values())
                                + sum(v[f"gather_gemm_{k}"] for v in opt_launches.values())
                                + sum(v[f"gather_gemm_{k}"] for v in aux_launches.values())
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
        "fully_sparse": {
            **{name: {"model": f"{fs_summary[name]['config'][6:]} at full width, bf16",
                      "launches_per_request": FULLY_SPARSE_B2[name][0],
                      "launches_per_train_step": FULLY_SPARSE_B2[name][1],
                      "cuda_core_per_request_and_step": FULLY_SPARSE_CUDA_CORE.get(name, (0, 0)),
                      **{path: {"unit": FS_UNITS[path], **totals}
                         for path, (totals, _) in by.items()}}
               for name, by in fs_b2.items()},
            "wide_and_125_tap_calls": [
                {k: e[k] for k in ("model", "path", "conv", "shape", "variant", "ms",
                                   "plain_ms", "library_ms", "bound_ms", "bound_by",
                                   "max_err_over_tol")} for e in fs_wide]},
        "transfusion": {
            "model": "nuscenes_models/transfusion_lidar.yaml at full width (VoxelResBackBone8x "
                     "16-32-64-128, 160,000 / 120,000 voxels), bf16",
            "train_launches_per_step": {"forward": TRANSFUSION_B2[0],
                                        "dx": TRANSFUSION_B2[1] - TRANSFUSION_B2[0]},
            "served_request": {"unit": "one served bf16 request: its 21 launches, summed",
                               **tf_b2["served"][0]},
            "train_dx": {"unit": "one bf16 train step: its 20 dX launches, summed",
                         **tf_b2["dx"][0]}},
        "dsvt": {name: {"model": f"{ds_summary[name]['config'][6:]} at full width, bf16",
                        "launches_per_request": DSVT_B2[name][0],
                        "launches_per_train_step": DSVT_B2[name][1]} for name in DSVT_DEPTH},
        "mppnet": {
            name: {"model": f"{mp_summary[name]['config'][6:]} at full width (VoxelBackBone8x "
                            "over 1504 x 1504 x 40, 150,000 voxels per frame, Cin 6), bf16",
                   "launches_per_request": MPPNET_B2[0],
                   "launches_per_train_step": MPPNET_B2[1],
                   "served_request": {"unit": "one served bf16 request: its 12 launches, summed",
                                      **mp_b2[name]["served"][0]},
                   "train_dx": {"unit": "one bf16 train step: its 11 dX launches, summed",
                                **mp_b2[name]["dx"][0]}}
            for name in MPPNET_DEPTH},
        "camera": {
            name: {"model": f"{cam_summary[name]['config'][11:]} at full width, bf16",
                   "launches_per_request": CAMERA_B2[name][0],
                   "launches_per_train_step": CAMERA_B2[name][1],
                   **{f"{path}": {"unit": "one served bf16 request, summed" if path == "served"
                                  else "one bf16 train step's dX launches, summed", **totals}
                      for path, (totals, _) in cam_b2[name].items()}}
            for name in CAMERA_MODELS if name in CAMERA_CONVS},
        "datasets": {
            "model": f"{WAYMO_CLI_CFG[5:]} at full width (VoxelResBackBone8x over 1504 x 1504 x "
                     "40, 150,000 voxels per frame, conv_input Cin 5) on frames read from disk, "
                     "bf16",
            "launches_per_request": {k: v[0] for k, v in DATASETS_B2.items()},
            "launches_per_train_step": {k: v[1] for k, v in DATASETS_B2.items() if v[1]},
            "served_request": {"unit": "one served bf16 Waymo request: its 21 launches, summed",
                               **dset_b2[0], "per_conv": compact_gemm(dset_b2[1])}},
        "options": {
            **{name: {"model": opt_summary[name]["config"],
                      "launches_per_request": OPTIONS_B2[name][0],
                      "launches_per_train_step": OPTIONS_B2[name][1]} for name in OPTIONS_DEPTH},
            "voxelnext_compact_served": {
                "unit": "one served bf16 voxelnext_compact request: its 52 launches, summed",
                **opt_b2[0], "per_conv": compact_gemm(opt_b2[1])}},
        "aux": {
            "model": "the gather leg of phase 22's A/B: kitti_models/second.yaml (VoxelBackBone8x, "
                     "40,000 / 16,000 voxels) at full width, bf16; the column form launches none",
            "launches_per_request": AUX_GATHER_B2[0],
            "launches_per_train_step": AUX_GATHER_B2[1],
            "served_request": {"unit": "one served bf16 second_gather request: its 12 launches, "
                                       "summed", **aux_b2[0], "per_conv": compact_gemm(aux_b2[1])}},
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
    log(json.dumps({"fully_sparse": fs_summary}, default=str))
    log(json.dumps({"transfusion": tf_summary}, default=str))
    log(json.dumps({"dsvt": ds_summary}, default=str))
    log(json.dumps({"mppnet": mp_summary}, default=str))
    log(json.dumps({"camera": cam_summary}, default=str))
    log(json.dumps({"datasets": dset_summary}, default=str))
    log(json.dumps({"options": opt_summary}, default=str))
    log(json.dumps({"aux": aux_summary}, default=str))
    log(json.dumps({"distributed": dist_summary}, default=str))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
