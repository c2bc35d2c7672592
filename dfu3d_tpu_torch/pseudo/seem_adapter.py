"""In-process SEEM/X-Decoder segmentation adapter (own copy of
dfu3d_tpu/pseudo/seem_adapter.py; reference: tools/PENet/vis_utils.py
SegSeem:169-224).

The reference calls an X-Decoder ("SEEM") open-vocabulary segmenter
in-process per frame: resize-800 BICUBIC, crop to 352x1216, prompt with the
thing-class list, keep instances with score > 0.7, and derive 2D boxes from
the bit masks. Three interchangeable backends:

* ``xdecoder`` — the reference's own stack (X-Decoder weights + detectron2
  utils), import-gated: constructing it without the packages raises with
  install instructions. Its input resize needs an imaging library, which
  the port does not use, so constructing it raises with them as well.
* ``artifact`` — reads the factory's out-of-process contract
  (``seem/<idx>.npz``); this is what the pseudo-box CLI uses.
* any callable ``image -> SegmentationResult`` — lets tests and custom
  segmenters drop in without touching the factory.

``SeemSegmenter.cache_artifact`` writes a result back as the npz contract,
so the artifact directory is what it is in the reference: a cache of the
in-process adapter's outputs.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional, Sequence, Union

import numpy as np

DEFAULT_THING_CLASSES = ("Car", "Pedestrian", "Person ride a bike")
SCORE_THRESH = 0.7         # ref vis_utils.py:221


@dataclass
class SegmentationResult:
    """One frame's instance segmentation (the SegSeem return contract)."""

    masks: np.ndarray    # (K, H, W) bool
    classes: np.ndarray  # (K,) int — indices into thing_classes
    scores: np.ndarray   # (K,) float
    boxes2d: np.ndarray  # (K, 4) x1 y1 x2 y2


def boxes2d_from_masks(masks: np.ndarray) -> np.ndarray:
    """Tight 2D boxes of bit masks (the detectron2
    ``BitMasks.get_bounding_boxes`` step at vis_utils.py:219). Empty masks
    produce a zero box, matching detectron2."""
    masks = np.asarray(masks).astype(bool)
    boxes = np.zeros((masks.shape[0], 4), np.float32)
    for i in range(masks.shape[0]):
        ys, xs = np.nonzero(masks[i])
        if len(xs):
            boxes[i] = (xs.min(), ys.min(), xs.max() + 1, ys.max() + 1)
    return boxes


class SeemSegmenter:
    """Front-end over the backends; ``__call__`` runs one frame."""

    def __init__(self,
                 backend: Union[str, Callable] = "artifact",
                 thing_classes: Sequence[str] = DEFAULT_THING_CLASSES,
                 artifact_root: Optional[Path] = None,
                 score_thresh: float = SCORE_THRESH,
                 weights_path: Optional[str] = None):
        self.thing_classes = list(thing_classes)
        self.score_thresh = float(score_thresh)
        self.artifact_root = Path(artifact_root) if artifact_root else None
        self._fn = None
        if callable(backend):
            self.backend = "callable"
            self._fn = backend
        elif backend == "artifact":
            self.backend = "artifact"
        elif backend == "xdecoder":
            self._build_xdecoder(weights_path)
        else:
            raise ValueError(f"unknown SEEM backend {backend!r}")

    # -- backends ----------------------------------------------------------

    def _build_xdecoder(self, weights_path):
        """The reference's stack (vis_utils.py:170-196), import-gated as in
        the JAX package. Its input resize (PIL BICUBIC, vis_utils.py:178)
        is not ported, so with the stack installed the backend raises too."""
        try:
            from xdecoder.BaseModel import BaseModel  # noqa: F401
            from xdecoder import build_model  # noqa: F401
            from utils.arguments import load_opt_command  # noqa: F401
            from utils.distributed import init_distributed  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "The xdecoder backend needs the X-Decoder package and its "
                "detectron2 utilities plus the xdecoder_focalt_best_openseg "
                "checkpoint (reference vis_utils.py:169-196). Install them "
                "and pass weights_path=, or use the 'artifact' backend with "
                "precomputed seem/<idx>.npz files."
            ) from e
        raise NotImplementedError(
            "the xdecoder backend resizes its input with PIL's BICUBIC filter, "
            "which this package does not use; run the segmenter out of process "
            "and use the 'artifact' backend")

    def _load_artifact(self, frame_id) -> SegmentationResult:
        if self.artifact_root is None:
            raise ValueError("artifact backend needs artifact_root=")
        seem = np.load(self.artifact_root / f"{frame_id}.npz")
        return SegmentationResult(
            masks=seem["masks"].astype(bool),
            classes=seem["classes"].astype(int),
            scores=seem["scores"].astype(np.float32),
            boxes2d=seem["boxes2d"].astype(np.float32),
        )

    # -- API ---------------------------------------------------------------

    def __call__(self, image, frame_id: Optional[str] = None) -> SegmentationResult:
        if self.backend == "artifact":
            return self._load_artifact(frame_id)
        res = self._fn(image)
        if res.boxes2d is None or not len(res.boxes2d):
            res.boxes2d = boxes2d_from_masks(res.masks)
        keep = np.asarray(res.scores) > self.score_thresh
        return SegmentationResult(
            masks=np.asarray(res.masks)[keep],
            classes=np.asarray(res.classes)[keep],
            scores=np.asarray(res.scores)[keep],
            boxes2d=np.asarray(res.boxes2d)[keep],
        )

    def cache_artifact(self, root: Path, frame_id: str,
                       result: SegmentationResult) -> Path:
        """Persist a result as the out-of-process npz contract, so a live
        segmenter populates the same cache the factory reads."""
        out = Path(root) / "seem"
        out.mkdir(parents=True, exist_ok=True)
        path = out / f"{frame_id}.npz"
        np.savez_compressed(
            path, masks=result.masks.astype(bool),
            classes=result.classes.astype(np.int64),
            scores=result.scores.astype(np.float32),
            boxes2d=result.boxes2d.astype(np.float32),
        )
        return path
