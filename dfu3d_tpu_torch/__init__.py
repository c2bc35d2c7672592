"""PyTorch / CUDA port of dfu3d_tpu for one NVIDIA H100.

It serves CenterPoint-pillar (`flagship`) and voxel CenterPoint (`zoo`)
predictions and the in-graph recall counters (`train.eval_utils.eval_batches`),
trains both, and makes their pseudo-labels from raw frames (`pseudo`: depth
completion and the LiDAR-camera fusion factory).
The two kernels of the JAX package are hand-written CUDA kernels for sm_90a:
the rotated-BEV overlap under NMS and recall (`core/geometry/csrc/iou_bev.cu`)
and the sparse gather-GEMM of every sparse conv
(`core/voxel/csrc/gather_gemm.cu`). Every entry point runs on the card unless
the caller passes ``device="cpu"``.
"""
