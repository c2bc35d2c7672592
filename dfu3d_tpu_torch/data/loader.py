"""Host-side data loader: deterministic per-host sharding + threaded prefetch.

Own copy of dfu3d_tpu/data/loader.py (itself the replacement of torch's
DataLoader + DistributedSampler): each host takes every `process_count`-th
index of a seeded, per-epoch reshuffled order (as sampler.set_epoch does),
loads and augments frames in a thread pool, and collates them into a
`PointBatch` of CPU tensors and a `BatchMeta`. The registry holds the same
ten names as the JAX package's (dfu3d_tpu/data/__init__.py).
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .argo2_dataset import Argo2Dataset
from .custom_dataset import CustomDataset
from .dataset import DatasetTemplate
from .kitti_dataset import KittiDataset, KittiKittiDataset
from .lyft_dataset import LyftDataset
from .nuscenes_dataset import NuScenesDataset
from .once_dataset import ONCEDataset
from .pandaset_dataset import PandasetDataset
from .waymo_dataset import WaymoDataset

__all_datasets__ = {
    "DatasetTemplate": DatasetTemplate,
    "KittiDataset": KittiDataset,
    "KittiKittiDataset": KittiKittiDataset,
    "NuScenesDataset": NuScenesDataset,
    "ONCEDataset": ONCEDataset,
    "CustomDataset": CustomDataset,
    "LyftDataset": LyftDataset,
    "WaymoDataset": WaymoDataset,
    "PandasetDataset": PandasetDataset,
    "Argo2Dataset": Argo2Dataset,
}


class DataLoader:
    def __init__(self, dataset, batch_size, shuffle=True, seed=666, num_workers=4,
                 drop_last=True, process_index=0, process_count=1, prefetch=2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.process_index = process_index
        self.process_count = process_count
        self.prefetch = prefetch
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _local_indices(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(order)
        # pad so every host sees the same number of batches (test-sampler
        # pad-to-divisible behaviour, datasets/__init__.py:31-51)
        per_host = int(np.ceil(n / self.process_count))
        padded = np.concatenate([order, order[: per_host * self.process_count - n]])
        return padded[self.process_index :: self.process_count]

    def __len__(self):
        local = len(self._local_indices())
        if self.drop_last:
            return local // self.batch_size
        return int(np.ceil(local / self.batch_size))

    def __iter__(self):
        indices = self._local_indices()
        nb = len(self)
        batches = [
            indices[i * self.batch_size : (i + 1) * self.batch_size] for i in range(nb)
        ]
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            # a failure is handed to the consumer, which raises it
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for batch_idx in batches:
                        if stop.is_set():
                            return
                        frames = list(pool.map(self.dataset.__getitem__, batch_idx))
                        out_q.put(self.dataset.collate_batch(frames))
                out_q.put(None)
            except Exception as e:  # noqa: BLE001 - re-raised in the consumer
                out_q.put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            # unblock a producer waiting on a full queue, then let it finish
            while t.is_alive():
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    t.join(timeout=0.05)


def build_dataloader(dataset_cfg, class_names, batch_size, root_path=None, workers=4,
                     seed=666, logger=None, training=True, merge_all_iters_to_one_epoch=False,
                     total_epochs=0, process_index=0, process_count=1):
    """The reference's build_dataloader surface (datasets/__init__.py:54-83):
    returns (dataset, loader)."""
    if dataset_cfg.DATASET not in __all_datasets__:
        raise NotImplementedError(
            f"dataset {dataset_cfg.DATASET} is not a registered dataset; registered: "
            f"{sorted(__all_datasets__)}")
    dataset = __all_datasets__[dataset_cfg.DATASET](
        dataset_cfg=dataset_cfg,
        class_names=class_names,
        root_path=root_path,
        training=training,
        logger=logger,
    )
    if merge_all_iters_to_one_epoch:
        dataset.merge_all_iters_to_one_epoch(merge=True, epochs=total_epochs)

    loader = DataLoader(
        dataset,
        batch_size=batch_size,
        shuffle=training,
        seed=seed,
        num_workers=workers,
        drop_last=training,
        process_index=process_index,
        process_count=process_count,
    )
    return dataset, loader
