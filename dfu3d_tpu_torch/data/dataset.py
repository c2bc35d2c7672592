"""Dataset template: per-frame prepare pipeline + static-shape batch collation.

Own copy of dfu3d_tpu/data/dataset.py (`DatasetTemplate`, `BatchMeta`). The
reference batches a ragged dict by concatenation with batch-index prefixes
(dataset.py:158-325); here a batch is the port's `PointBatch` of fixed-size
padded tensors plus validity masks (`data/batch.py`), and per-frame host
metadata (frame ids, calibrations, image shapes) rides in a separate
`BatchMeta` that never leaves the host.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, NamedTuple

import numpy as np

from .batch import PointBatch
from .data_augmentor import DataAugmentor
from .point_feature_encoder import PointFeatureEncoder
from .processor import DataProcessor


class BatchMeta(NamedTuple):
    """Host-side per-frame metadata (not a device tensor)."""

    frame_ids: List[Any]
    calibs: List[Any]
    image_shapes: List[Any]


class DatasetTemplate:
    """Pipeline skeleton (reference DatasetTemplate semantics, dataset.py:15-156)."""

    def __init__(self, dataset_cfg=None, class_names=None, training=True,
                 root_path=None, logger=None):
        self.dataset_cfg = dataset_cfg
        self.training = training
        self.class_names = class_names
        self.logger = logger
        self.root_path = Path(
            root_path if root_path is not None else dataset_cfg.DATA_PATH
        )
        self.point_cloud_range = np.array(
            dataset_cfg.POINT_CLOUD_RANGE, dtype=np.float32
        )
        self.point_feature_encoder = PointFeatureEncoder(
            dataset_cfg.POINT_FEATURE_ENCODING,
            point_cloud_range=self.point_cloud_range,
        )
        self.data_augmentor = (
            DataAugmentor(
                self.root_path,
                dataset_cfg.DATA_AUGMENTOR,
                self.class_names,
                logger=self.logger,
            )
            if self.training and dataset_cfg.get("DATA_AUGMENTOR", None)
            else None
        )
        self.data_processor = DataProcessor(
            dataset_cfg.DATA_PROCESSOR,
            point_cloud_range=self.point_cloud_range,
            training=self.training,
            num_point_features=self.point_feature_encoder.num_point_features,
        )
        self.grid_size = self.data_processor.grid_size
        self.voxel_size = self.data_processor.voxel_size

        # static batch caps
        self.max_points_per_frame = int(
            dataset_cfg.get("MAX_POINTS_PER_FRAME", 65536)
        )
        self.max_gt_per_frame = int(dataset_cfg.get("MAX_GT_PER_FRAME", 256))
        # geometric box width: 7, or 9 when gt carries (vx, vy)
        self.gt_box_width = 9 if dataset_cfg.get("USE_VELOCITY", False) else 7

        self.mode = "train" if training else "test"
        self._merge_all_iters_to_one_epoch = False
        self.total_epochs = 0

    @property
    def num_point_features(self):
        return self.point_feature_encoder.num_point_features

    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, index):
        raise NotImplementedError

    def _resample(self, retry: int) -> int:
        """Bounded re-roll index for gt-less training frames (the reference's
        resample-on-empty, dataset.py:214-218). Raises after 64 misses: with
        an all-empty label set the unbounded form recurses forever."""
        if retry >= 64:
            raise RuntimeError(
                "resample-on-empty exceeded 64 attempts: every sampled "
                "frame has zero gt boxes — are the training labels empty?"
            )
        return int(np.random.randint(len(self)))

    def prepare_data(self, data_dict: Dict) -> Dict:
        """Augment → class filter + id append → encode → process.

        (reference dataset.py:158-218; the resample-on-empty-gt behaviour is
        kept through the `_needs_resample` flag the caller checks.)
        """
        if self.training:
            assert "gt_boxes" in data_dict, "gt_boxes required for training"
            gt_boxes_mask = np.array(
                [n in self.class_names for n in data_dict["gt_names"]], dtype=bool
            )
            calib = data_dict.get("calib", None)
            data_dict = self.data_augmentor.forward(
                {**data_dict, "gt_boxes_mask": gt_boxes_mask}
            ) if self.data_augmentor is not None else data_dict
            if calib is not None:
                data_dict["calib"] = calib

        if data_dict.get("gt_boxes", None) is not None:
            selected = [
                i for i, n in enumerate(data_dict["gt_names"]) if n in self.class_names
            ]
            data_dict["gt_boxes"] = data_dict["gt_boxes"][selected]
            data_dict["gt_names"] = data_dict["gt_names"][selected]
            gt_classes = np.array(
                [self.class_names.index(n) + 1 for n in data_dict["gt_names"]],
                dtype=np.int32,
            )
            geom = data_dict["gt_boxes"][:, : self.gt_box_width].astype(
                np.float32
            )
            if geom.shape[1] < self.gt_box_width:  # 7-dim source, vel wanted
                geom = np.concatenate(
                    [geom, np.zeros((len(geom), self.gt_box_width
                                     - geom.shape[1]), np.float32)], axis=1,
                )
            data_dict["gt_boxes"] = np.concatenate(
                [geom, gt_classes.reshape(-1, 1).astype(np.float32)], axis=1
            )

        if data_dict.get("points", None) is not None:
            data_dict = self.point_feature_encoder.forward(data_dict)

        data_dict = self.data_processor.forward(data_dict)

        data_dict["_needs_resample"] = bool(
            self.training and len(data_dict.get("gt_boxes", [])) == 0
        )
        data_dict.pop("gt_names", None)
        return data_dict

    def collate_batch(self, batch_list: List[Dict]):
        """Pad each frame to (max_points_per_frame, max_gt_per_frame) and stack.

        Returns (PointBatch of CPU tensors, BatchMeta). Replaces the
        reference's ragged concat-with-batch-index collate (dataset.py:220-325).
        """
        bs = len(batch_list)
        n_max, m_max = self.max_points_per_frame, self.max_gt_per_frame
        c = batch_list[0]["points"].shape[1]

        points = np.zeros((bs, n_max, c), dtype=np.float32)
        points_valid = np.zeros((bs, n_max), dtype=bool)
        gt_boxes = np.zeros((bs, m_max, self.gt_box_width + 1),
                            dtype=np.float32)
        gt_valid = np.zeros((bs, m_max), dtype=bool)
        frame_ids, calibs, image_shapes = [], [], []

        for i, d in enumerate(batch_list):
            pts = d["points"]
            if len(pts) > n_max:
                # keep a random subset — points were already shuffled upstream
                pts = pts[:n_max]
            points[i, : len(pts)] = pts
            points_valid[i, : len(pts)] = True
            gb = d.get("gt_boxes", None)
            if gb is not None and len(gb):
                gb = gb[:m_max]
                # geometry left-aligned, class id pinned to the LAST column
                # (a 7-dim frame in a velocity-width batch keeps vel = 0)
                gt_boxes[i, : len(gb), : gb.shape[1] - 1] = gb[:, :-1]
                gt_boxes[i, : len(gb), -1] = gb[:, -1]
                gt_valid[i, : len(gb)] = True
            frame_ids.append(d.get("frame_id"))
            calibs.append(d.get("calib"))
            image_shapes.append(d.get("image_shape"))

        return (
            PointBatch.from_numpy(points, points_valid, gt_boxes, gt_valid),
            BatchMeta(frame_ids, calibs, image_shapes),
        )

    def merge_all_iters_to_one_epoch(self, merge=True, epochs=None):
        self._merge_all_iters_to_one_epoch = merge
        self.total_epochs = epochs or 0

    def generate_prediction_dicts(self, batch_meta, pred_dicts, class_names,
                                  output_path=None):
        raise NotImplementedError

    def evaluation(self, det_annos, class_names, **kwargs):
        raise NotImplementedError
