"""Logging and seeding (own copy of dfu3d_tpu/utils/common.py, itself the
reference's pcdet/utils/common_utils.py). The device is an argument of every
entry point, so there is no platform switch here."""
from __future__ import annotations

import logging
import random

import numpy as np
import torch


def create_logger(log_file=None, rank=0, log_level=logging.INFO):
    """Logger to the console and, with `log_file`, to that file; ranks other
    than 0 log errors only."""
    logger = logging.getLogger(str(log_file) if log_file else "dfu3d")
    logger.setLevel(log_level if rank == 0 else logging.ERROR)
    logger.propagate = False
    if logger.handlers:
        return logger
    formatter = logging.Formatter("%(asctime)s  %(levelname)5s  %(message)s")
    console = logging.StreamHandler()
    console.setLevel(log_level if rank == 0 else logging.ERROR)
    console.setFormatter(formatter)
    logger.addHandler(console)
    if log_file is not None:
        fh = logging.FileHandler(log_file)
        fh.setLevel(log_level if rank == 0 else logging.ERROR)
        fh.setFormatter(formatter)
        logger.addHandler(fh)
    return logger


def close_logger(logger):
    """Close and detach every handler of `logger` (its log file included)."""
    for handler in list(logger.handlers):
        handler.close()
        logger.removeHandler(handler)


def set_random_seed(seed: int):
    """Seed Python's, numpy's and torch's generators (torch's draws the
    models' initial weights)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
