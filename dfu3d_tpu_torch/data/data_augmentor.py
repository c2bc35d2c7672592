"""Config-driven augmentation queue (own copy of
dfu3d_tpu/data/data_augmentor.py; reference: augmentor/data_augmentor.py).

Each augmentation is a named method dispatched from AUG_CONFIG_LIST; the queue
can be disabled per-entry (DISABLE_AUG_LIST) or entirely (disable_augmentation
hook for the last epochs, reference train_utils.py:257-272).
"""
from __future__ import annotations

from functools import partial

import numpy as np

from . import augmentor_utils
from .database_sampler import DataBaseSampler


class DataAugmentor:
    def __init__(self, root_path, augmentor_configs, class_names, logger=None, rng=None):
        self.root_path = root_path
        self.class_names = class_names
        self.logger = logger
        self.rng = rng if rng is not None else np.random.RandomState()

        self.data_augmentor_queue = []
        aug_config_list = (
            augmentor_configs
            if isinstance(augmentor_configs, list)
            else augmentor_configs.AUG_CONFIG_LIST
        )
        self.disable_list = (
            []
            if isinstance(augmentor_configs, list)
            else augmentor_configs.get("DISABLE_AUG_LIST", [])
        )
        for cur_cfg in aug_config_list:
            if cur_cfg.NAME in self.disable_list:
                continue
            cur_augmentor = getattr(self, cur_cfg.NAME)(config=cur_cfg)
            self.data_augmentor_queue.append(cur_augmentor)

    # --- augmentation factories (names are config keys) ---

    def gt_sampling(self, config=None):
        return DataBaseSampler(
            root_path=self.root_path,
            sampler_cfg=config,
            class_names=self.class_names,
            logger=self.logger,
            rng=self.rng,
        )

    def random_world_flip(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_world_flip, config=config)
        gt_boxes, points = data_dict["gt_boxes"], data_dict["points"]
        for cur_axis in config["ALONG_AXIS_LIST"]:
            assert cur_axis in ["x", "y"]
            fn = getattr(augmentor_utils, f"random_flip_along_{cur_axis}")
            gt_boxes, points, enabled = fn(gt_boxes, points, self.rng)
            data_dict[f"flip_{cur_axis}"] = enabled
        data_dict["gt_boxes"], data_dict["points"] = gt_boxes, points
        return data_dict

    def random_world_rotation(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_world_rotation, config=config)
        rot_range = config["WORLD_ROT_ANGLE"]
        if not isinstance(rot_range, (list, tuple)):
            rot_range = [-rot_range, rot_range]
        gt_boxes, points, angle = augmentor_utils.global_rotation(
            data_dict["gt_boxes"], data_dict["points"], rot_range, self.rng
        )
        data_dict["gt_boxes"], data_dict["points"] = gt_boxes, points
        data_dict["noise_rot"] = angle
        return data_dict

    def random_world_scaling(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_world_scaling, config=config)
        gt_boxes, points, scale = augmentor_utils.global_scaling(
            data_dict["gt_boxes"], data_dict["points"], config["WORLD_SCALE_RANGE"], self.rng
        )
        data_dict["gt_boxes"], data_dict["points"] = gt_boxes, points
        data_dict["noise_scale"] = scale
        return data_dict

    def random_world_translation(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_world_translation, config=config)
        gt_boxes, points, offset = augmentor_utils.global_translation(
            data_dict["gt_boxes"], data_dict["points"], config["NOISE_TRANSLATE_STD"], self.rng
        )
        data_dict["gt_boxes"], data_dict["points"] = gt_boxes, points
        data_dict["noise_translate"] = offset
        return data_dict

    def random_local_translation(self, data_dict=None, config=None):
        """Per-box jitter along configured axes (reference data_augmentor.py:158)."""
        if data_dict is None:
            return partial(self.random_local_translation, config=config)
        rng_range = config["LOCAL_TRANSLATION_RANGE"]
        gt_boxes, points = data_dict["gt_boxes"], data_dict["points"]
        for axis in config["ALONG_AXIS_LIST"]:
            assert axis in ("x", "y", "z")
            fn = getattr(augmentor_utils, f"random_local_translation_along_{axis}")
            gt_boxes, points = fn(gt_boxes, points, rng_range, self.rng)
        data_dict["gt_boxes"], data_dict["points"] = gt_boxes, points
        return data_dict

    def random_local_rotation(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_local_rotation, config=config)
        rot_range = config["LOCAL_ROT_ANGLE"]
        if not isinstance(rot_range, (list, tuple)):
            rot_range = [-rot_range, rot_range]
        gt_boxes, points = augmentor_utils.local_rotation(
            data_dict["gt_boxes"], data_dict["points"], rot_range, self.rng
        )
        data_dict["gt_boxes"], data_dict["points"] = gt_boxes, points
        return data_dict

    def random_local_scaling(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_local_scaling, config=config)
        gt_boxes, points = augmentor_utils.local_scaling(
            data_dict["gt_boxes"], data_dict["points"],
            config["LOCAL_SCALE_RANGE"], self.rng,
        )
        data_dict["gt_boxes"], data_dict["points"] = gt_boxes, points
        return data_dict

    def random_world_frustum_dropout(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_world_frustum_dropout, config=config)
        intensity_range = config["INTENSITY_RANGE"]
        gt_boxes, points = data_dict["gt_boxes"], data_dict["points"]
        for direction in config["DIRECTION"]:
            assert direction in ("top", "bottom", "left", "right")
            gt_boxes, points = augmentor_utils.global_frustum_dropout(
                gt_boxes, points, intensity_range, direction, self.rng
            )
        data_dict["gt_boxes"], data_dict["points"] = gt_boxes, points
        return data_dict

    def random_local_frustum_dropout(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_local_frustum_dropout, config=config)
        intensity_range = config["INTENSITY_RANGE"]
        gt_boxes, points = data_dict["gt_boxes"], data_dict["points"]
        for direction in config["DIRECTION"]:
            assert direction in ("top", "bottom", "left", "right")
            gt_boxes, points = augmentor_utils.local_frustum_dropout(
                gt_boxes, points, intensity_range, direction, self.rng
            )
        data_dict["gt_boxes"], data_dict["points"] = gt_boxes, points
        return data_dict

    def random_local_pyramid_aug(self, data_dict=None, config=None):
        """Pyramid dropout → sparsify → swap chain (reference :245-271)."""
        if data_dict is None:
            return partial(self.random_local_pyramid_aug, config=config)
        gt_boxes, points = data_dict["gt_boxes"], data_dict["points"]
        gt_boxes, points, pyramids = augmentor_utils.local_pyramid_dropout(
            gt_boxes, points, config["DROP_PROB"], self.rng
        )
        gt_boxes, points, pyramids = augmentor_utils.local_pyramid_sparsify(
            gt_boxes, points, config["SPARSIFY_PROB"],
            config["SPARSIFY_MAX_NUM"], self.rng, pyramids=pyramids,
        )
        gt_boxes, points = augmentor_utils.local_pyramid_swap(
            gt_boxes, points, config["SWAP_PROB"], config["SWAP_MAX_NUM"],
            self.rng, pyramids=pyramids,
        )
        data_dict["gt_boxes"], data_dict["points"] = gt_boxes, points
        return data_dict

    def random_image_flip(self, data_dict=None, config=None):
        """Multimodal horizontal image flip (JAX data_augmentor.py:177-192;
        reference :116): with probability 0.5 from the augmentor's `rng`
        (one uniform draw per frame that has images, none otherwise), the
        image and depth map flipped and `image_flipped` set."""
        if data_dict is None:
            return partial(self.random_image_flip, config=config)
        if "images" not in data_dict or self.rng.uniform(0, 1) > 0.5:
            return data_dict
        image, depth_map, gt_boxes = augmentor_utils.random_image_flip_horizontal(
            data_dict["images"], data_dict.get("depth_maps"), data_dict["gt_boxes"],
            data_dict.get("calib"))
        data_dict["images"] = image
        if depth_map is not None:
            data_dict["depth_maps"] = depth_map
        data_dict["image_flipped"] = True
        return data_dict

    def disable_augmentation(self, augmentor_configs):
        """Rebuild the queue with extra disables (disable-aug-last-epochs hook)."""
        self.data_augmentor_queue = []
        aug_config_list = (
            augmentor_configs
            if isinstance(augmentor_configs, list)
            else augmentor_configs.AUG_CONFIG_LIST
        )
        disable = (
            []
            if isinstance(augmentor_configs, list)
            else augmentor_configs.get("DISABLE_AUG_LIST", [])
        )
        for cur_cfg in aug_config_list:
            if cur_cfg.NAME in disable:
                continue
            self.data_augmentor_queue.append(getattr(self, cur_cfg.NAME)(config=cur_cfg))

    def forward(self, data_dict):
        for cur_augmentor in self.data_augmentor_queue:
            data_dict = cur_augmentor(data_dict=data_dict) if not isinstance(
                cur_augmentor, DataBaseSampler
            ) else cur_augmentor(data_dict)
        # normalize headings into [-pi, pi) like the reference (dataset.py:189-192)
        if "gt_boxes" in data_dict and len(data_dict["gt_boxes"]):
            from .np_geometry import limit_period

            data_dict["gt_boxes"][:, 6] = limit_period(
                data_dict["gt_boxes"][:, 6], offset=0.5, period=2 * np.pi
            )
        return data_dict
