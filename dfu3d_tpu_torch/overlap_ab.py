"""Kernel B1 (rotated-BEV overlap) against another tree's B1, on the card.

    python -m dfu3d_tpu_torch.overlap_ab --parent DIR [--out FILE.json]

DIR holds an unpacked checkout of another commit (for example `git archive
HEAD` unpacked into .proof/parent). Both trees' `iou_bev.cu` are built (one
nvcc each, at once) and launched through their C entry points on the same
inputs: chip_smoke.py's phase-3 overlap cases, and the overlap calls (NMS,
recall) of one served bf16 request per path (pillar, voxel; seeded weights,
batch seed 0), recorded as chip_smoke.py records them. For each problem it
reports whether the two outputs are equal (`torch.equal`) and equal bit for
bit, the survivor and overlapping shares, and both kernels' times taken in
turns (parent, this tree, this tree, parent) with chip_smoke.time_ms. For
each path's served NMS problem it also times the IoU stage around the kernel
(`pairwise_iou_bev` on the boxes NMS gives it: corners, kernel, IoU ratio)
and the thresholded upper-triangle mask that the keep-scan builds from it.
One JSON object, printed and written to --out. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from . import cuda_build
from .core.geometry import iou, iou_kernel
from .core.geometry import nms as nms_mod
from .data.batch import synthetic_batch
from .flagship import flagship, seeded_weights_
from .zoo import voxel_centerpoint

REPO = Path(__file__).resolve().parents[1]
ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def launch(fn, ca, cb):
    g, n, m = ca.shape[0], ca.shape[1], cb.shape[1]
    out = torch.empty((g, n, m), dtype=torch.float32, device=ca.device)
    rc = fn(ca.data_ptr(), cb.data_ptr(), out.data_ptr(), g, n, m,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"overlap kernel launch failed with CUDA error {rc}")
    return out


def problems(smoke, device):
    """[(name, corners_a, corners_b)]: phase-3 cases, then served calls; and
    {path: (boxes NMS gave pairwise_iou_bev, NMS threshold)}."""
    out = [(name, smoke.corners(a), smoke.corners(b))
           for name, (a, b) in smoke.overlap_cases(device).items()]
    batch = synthetic_batch(4, 60000, 256, 50.0, seed=0)
    nms_boxes = {}
    orig_iou_bev = nms_mod.pairwise_iou_bev
    for path, build in (("pillar", flagship), ("voxel", voxel_centerpoint)):
        cfg, _, model = build(device=device)
        seeded_weights_(model, seed=0)
        seen = []
        nms_mod.pairwise_iou_bev = lambda a, b: (seen.append(a), orig_iou_bev(a, b))[1]
        try:
            out += [(f"served_{path}_{name}", ca, cb)
                    for name, ca, cb in smoke.served_overlap_problems(model, batch, device)]
        finally:
            nms_mod.pairwise_iou_bev = orig_iou_bev
        thresh = float(cfg.MODEL.DENSE_HEAD.POST_PROCESSING.NMS_CONFIG.NMS_THRESH)
        nms_boxes[path] = (seen[0], thresh)
        del model
    return out, nms_boxes


def iou_stage(smoke, boxes, thresh):
    """Device ms of the NMS IoU stage on one served problem: the whole of
    pairwise_iou_bev, the kernel alone on its corners, and the keep-scan's
    thresholded upper-triangle mask (nms._suppression_scan's first line)."""
    ca = cb = smoke.corners(boxes[..., :7].float())
    ious = iou.pairwise_iou_bev(boxes, boxes)
    idx = torch.arange(ious.shape[-1], device=ious.device)
    return {
        "shape": list(ious.shape),
        "pairwise_iou_bev_ms": smoke.time_ms(lambda: iou.pairwise_iou_bev(boxes, boxes)),
        "kernel_ms": smoke.time_ms(lambda: iou_kernel.overlap_bev(ca, cb)),
        "threshold_mask_ms": smoke.time_ms(
            lambda: (ious > thresh) & (idx[:, None] < idx[None, :])),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("overlap_ab needs a CUDA device")
    sys.path.insert(0, str(REPO))
    import chip_smoke as smoke

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    parent_src = (args.parent / iou_kernel.SOURCE.relative_to(REPO)).resolve()
    flags = iou_kernel.NVCC_FLAGS
    cuda_build.build((iou_kernel.SOURCE, flags), (parent_src, flags))
    kernels = {"parent": cuda_build.load(parent_src, flags, "dfu3d_overlap_bev", ARGTYPES),
               "change": cuda_build.load(iou_kernel.SOURCE, flags, "dfu3d_overlap_bev",
                                         ARGTYPES)}
    device = torch.device("cuda")
    rows = []
    cases, nms_boxes = problems(smoke, device)
    for name, ca, cb in cases:
        old, new = launch(kernels["parent"], ca, cb), launch(kernels["change"], ca, cb)
        torch.cuda.synchronize()
        culled = iou_kernel.overlap_bev_cull_plain(ca, cb)
        times = {}
        for turn in ("parent", "change", "change", "parent"):
            fn = kernels[turn]
            times.setdefault(turn, []).append(
                smoke.time_ms(lambda: launch(fn, ca, cb)))
        row = {"problem": name, "shape": list(new.shape),
               "equal": torch.equal(old, new),
               "bit_equal": torch.equal(old.view(torch.int32), new.view(torch.int32)),
               "survivor_share": 1.0 - culled.float().mean().item(),
               "overlapping_share": (new > 0).float().mean().item(),
               "parent_ms": times["parent"], "change_ms": times["change"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    stage = {path: iou_stage(smoke, b, t) for path, (b, t) in nms_boxes.items()}
    print(json.dumps(stage), flush=True)
    result = {"device": smi.stdout.strip(), "parent": str(args.parent), "problems": rows,
              "all_bit_equal": all(r["bit_equal"] for r in rows), "nms_iou_stage": stage}
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    if not result["all_bit_equal"]:
        raise SystemExit("overlap_ab: the two kernels' outputs differ")


if __name__ == "__main__":
    main()
