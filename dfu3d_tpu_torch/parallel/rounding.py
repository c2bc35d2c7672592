"""How far the data-parallel fp32 step lies from the one-process step on the
same global batch, beside what reordering alone moves it, on the card.

    python -m dfu3d_tpu_torch.parallel.rounding [--model voxel] [--shifts 3 0]
                                                [--cudnn on off] [--out FILE.json]

For each BN-bias shift (every BN bias + shift, as `seeded_state` applies
it) and each cuDNN setting (off: the dense convs run PyTorch's own CUDA
kernels, whose algorithm does not change with the batch size), one fp32 step of the model at full width with seeded weights on the
global batch of 8 synthetic frames (`global_batches`): at world 1, at world
1 with the batch's halves swapped (the same function summed in another
order), and on 2 gloo ranks sharing the card, each on its 4 rows (spawned,
TF32 off). Reports per run pair and per gradient leaf the largest
difference over the leaf's largest entry, every loss term's relative
difference and the BN statistics' (of 1 + |x|), the leaves sorted by the
world-2 gap, the world-2 gap over the swap's per leaf, and the largest
such ratio among the leaves whose world-2 gap passes GRAD_TOL. One JSON
object, printed and written to --out. Needs a CUDA device.

The shift sets how far from 0 the ReLU inputs sit: at +3 no input lies
within rounding of the kink, and every conv's input has a mean about three
times its spread, which makes the weight gradients' sums (Σ x·g with Σ g =
0 per channel under a BN in training) cancel.
"""
from __future__ import annotations

import argparse
import functools
import itertools
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

TOTAL_STEPS = 1000       # the one-cycle schedule's length
WORLD, BATCH = 2, 4      # ranks, frames per rank
GRAD_TOL = 1e-3          # of a leaf's scale: "needed_spread" counts the leaves past it


def seeded_state(device, kind: str, shift: float = 3.0, total_steps: int = TOTAL_STEPS):
    """A TrainState of the flagship ("pillar") or voxel CenterPoint ("voxel",
    its train voxel cap) at full width with seeded weights and every BN
    bias + `shift`, the config's adam_onecycle over `total_steps`."""
    from ..flagship import flagship, seeded_weights_
    from ..train.train_state import create_train_state
    from ..zoo import voxel_centerpoint

    cfg, _, model = (flagship if kind == "pillar" else voxel_centerpoint)(device=device,
                                                                          train=True)
    seeded_weights_(model, seed=0)
    with torch.no_grad():
        for m in model.modules():
            if hasattr(m, "running_mean") and hasattr(m, "bias"):
                m.bias += shift
    return create_train_state(model, cfg.OPTIMIZATION, total_steps)


def global_batches(kind: str, n: int, b: int, seed: int = 0):
    """n global batches of b frames: 60,000 uniform points, 256 gt slots
    (10 columns for the voxel model's vel branch)."""
    from ..data.batch import synthetic_batch

    return [synthetic_batch(b, 60000, 256, 50.0, seed=seed + s, velocity=kind == "voxel")
            for s in range(n)]


def swap_halves(batches, b: int):
    """Each batch with its rows [b:] first, then [:b]."""
    return [type(x)(*(torch.cat([t[b:], t[:b]]) for t in x)) for x in batches]


def _runs(rank, world, kind, shifts, cudnn=("on",), device="cuda"):
    """This rank's first-step gradients, metrics and BN statistics at each
    shift and cuDNN setting, on its rows of the global batch and (world 1)
    of the swapped one."""
    from .launch import train_rank

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    batches = global_batches(kind, 1, WORLD * BATCH)
    out = {}
    for shift, use in itertools.product(shifts, cudnn):
        torch.backends.cudnn.enabled = use == "on"
        build = functools.partial(seeded_state, kind=kind, shift=shift)
        for tag, b in (("as_is", batches), ("swapped", swap_halves(batches, BATCH))):
            if tag == "swapped" and world > 1:
                continue
            run = train_rank(rank, world, build, b, device=device, dtype=torch.float32,
                             keep_grads=True)
            out[f"{shift}/{use}/{tag}"] = {
                "grads": run["grads"][0], "metrics": run["metrics"][0],
                "bn": {k: v for k, v in run["state"].items()
                       if k.endswith(("running_mean", "running_var"))}}
            if device != "cpu":
                torch.cuda.empty_cache()
    torch.backends.cudnn.enabled = True
    return out


def leaf_scale(grads, key):
    """A gradient leaf's largest |entry|; a bias's is at least its module
    weight's (a bias in front of a BN has a gradient of rounding noise)."""
    scale = max(float(np.abs(grads[key]).max()), 1e-30)
    module, leaf = key.rsplit(".", 1)
    if leaf == "bias" and f"{module}.weight" in grads:
        scale = max(scale, float(np.abs(grads[f"{module}.weight"]).max()))
    return scale


def gaps(a, b):
    """a against b: the largest gradient difference per leaf over b's
    `leaf_scale`, each metric's relative difference, the largest BN
    statistic difference of 1 + |x|."""
    grads = {k: float(np.abs(a["grads"][k] - w).max()) / leaf_scale(b["grads"], k)
             for k, w in b["grads"].items()}
    metrics = {k: abs(a["metrics"][k] - w) / max(abs(w), 1e-30) for k, w in b["metrics"].items()}
    bn = max(float((np.abs(a["bn"][k] - w) / (1 + np.abs(w))).max()) for k, w in b["bn"].items())
    return grads, metrics, bn


def main(argv=None):
    from .. import cuda_build
    from ..core.voxel import gather_gemm_kernel
    from .launch import run_ranks, to_host

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", choices=("voxel", "pillar"), default="voxel")
    p.add_argument("--shifts", type=float, nargs="+", default=[3.0, 0.0])
    p.add_argument("--cudnn", choices=("on", "off"), nargs="+", default=["on"])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    cuda_build.build((gather_gemm_kernel.SOURCE, gather_gemm_kernel.NVCC_FLAGS))
    one = to_host(_runs(0, 1, args.model, args.shifts, args.cudnn))
    two = run_ranks(_runs, WORLD, args=(args.model, args.shifts, args.cudnn), device="cuda",
                    backend="gloo", timeout_s=900)
    report = {"card": card, "model": args.model, "world": WORLD, "batch_per_rank": BATCH,
              "runs": {}}
    for shift, use in itertools.product(args.shifts, args.cudnn):
        run = f"{shift}/{use}"
        w1, sw, w2 = one[f"{run}/as_is"], one[f"{run}/swapped"], two[0][f"{run}/as_is"]
        g21, m21, bn21 = gaps(w2, w1)
        gsw, msw, bnsw = gaps(sw, w1)
        ranks_equal = all(np.array_equal(two[1][f"{run}/as_is"]["grads"][k], v)
                          for k, v in w2["grads"].items())
        ratio = {k: g21[k] / max(gsw[k], 1e-12) for k in g21}
        leaves = sorted(g21, key=lambda k: -g21[k])
        report["runs"][f"shift {shift}, cudnn {use}"] = {
            "world2_vs_world1": {"grad_max": max(g21.values()), "loss_rel_max": max(m21.values()),
                                 "bn_max": bn21},
            "swapped_vs_world1": {"grad_max": max(gsw.values()), "loss_rel_max": max(msw.values()),
                                  "bn_max": bnsw},
            "ratio_max": max(ratio.values()),
            "needed_spread": max([g21[k] / gsw[k] if gsw[k] else float("inf")
                                  for k in g21 if g21[k] > GRAD_TOL], default=0.0),
            "leaves_over_1e-3": {"world2": sum(v > 1e-3 for v in g21.values()),
                                 "swapped": sum(v > 1e-3 for v in gsw.values()),
                                 "of": len(g21)},
            "ranks_grads_equal": ranks_equal,
            "loss": w1["metrics"]["loss"],
            "metrics": {k: {"world2": m21[k], "swapped": msw[k]} for k in m21},
            "worst_leaves": [{"leaf": k, "world2": g21[k], "swapped": gsw[k],
                              "ratio": ratio[k]} for k in leaves[:12]]}
    text = json.dumps(report, indent=1)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    return report


if __name__ == "__main__":
    main()
