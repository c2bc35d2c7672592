"""Spherical-grid resampling of point clouds (port of
dfu3d_tpu/core/voxel/spherical.py; reference la_sampling2 / la_sampling20,
tools/PENet/dataloaders/my_loader.py:166-275).

Pseudo-points lifted from dense depth are resampled on a spherical (range,
azimuth, elevation) grid so that at most one representative survives per
angular cell: the reference uses a spconv voxelizer with vsize ≈ [200 m,
0.002 rad, 0.002 rad] and at most 1 point per voxel. The minimum-range point
per angular bin (the visible surface) is kept, with two stable sorts instead
of a hash-table voxelizer.
"""
from __future__ import annotations

import math

import torch


def to_sphere_coords(points):
    """(N, 3+) xyz → (range, azimuth, elevation), each (N,): azimuth =
    atan2(y, x), elevation = asin(z / r)."""
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    r = torch.sqrt(x * x + y * y + z * z)
    az = torch.atan2(y, x)
    el = torch.asin(z / torch.clamp(r, min=1e-6))
    return r, az, el


def angular_bins(points, valid, az_res: float = 0.002, el_res: float = 0.002):
    """(N,) int64 cell of each point, azimuth-major; invalid points get the
    one-past-last cell. Returns (bin ids, that cell)."""
    _, az, el = to_sphere_coords(points)
    n_az = int(math.ceil(2 * math.pi / az_res)) + 1
    n_el = int(math.ceil(math.pi / el_res)) + 1
    az_bin = torch.clamp(((az + math.pi) / az_res).to(torch.int32), 0, n_az - 1)
    el_bin = torch.clamp(((el + math.pi / 2) / el_res).to(torch.int32), 0, n_el - 1)
    bin_id = az_bin.long() * n_el + el_bin.long()
    return torch.where(valid, bin_id, n_az * n_el), n_az * n_el


def spherical_min_range_resample(points, valid, az_res: float = 0.002,
                                 el_res: float = 0.002, keep: str = "min_range"):
    """Keep one point per (azimuth, elevation) cell.

    points (N, 3+) fp32, valid (N,) bool; az_res, el_res: the cells' sizes
    in radians (reference: 0.002); keep: "min_range" (the closest surface) or
    "first" (input order, the spconv voxelizer's behaviour). Returns the (N,)
    bool mask of the surviving points."""
    n = points.shape[0]
    bin_id, padding = angular_bins(points, valid, az_res, el_res)
    if keep == "min_range":
        # stable two-pass sort: group by cell, ascending range within a cell
        r = to_sphere_coords(points)[0]
        order_r = torch.sort(r, stable=True).indices
        order = order_r[torch.sort(bin_id[order_r], stable=True).indices]
    else:
        order = torch.sort(bin_id, stable=True).indices
    sorted_bin = bin_id[order]
    first = torch.ones_like(sorted_bin, dtype=torch.bool)
    first[1:] = sorted_bin[1:] != sorted_bin[:-1]
    first &= sorted_bin < padding
    mask = torch.zeros(n, dtype=torch.bool, device=points.device)
    mask[order] = first
    return mask & valid
