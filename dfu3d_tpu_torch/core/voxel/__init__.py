from .spherical import spherical_min_range_resample, to_sphere_coords  # noqa: F401
from .voxelize import (  # noqa: F401
    Voxelized,
    VoxelGrid,
    dynamic_voxelize,
    linear_index_3d,
    segment_broadcast,
    segment_max,
    segment_max_fast,
    segment_mean,
    segment_sum,
    segment_sum_sorted,
    voxel_coords_of_points,
)
