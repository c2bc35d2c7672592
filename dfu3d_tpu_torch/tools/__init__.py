"""Command-line entry points: `python -m dfu3d_tpu_torch.tools.nuscenes2kitti`
(pipeline 1), `.complete_depth` and `.generate_pseudo_boxes` (pipeline 2),
`.create_infos`, `.train` and `.test` (pipelines 3 and 4), `.evolve` (the
self-evolution rounds of pipeline 4) and `.e2e_synthetic` (all four on a
synthetic dataset). Each module's `main(argv=None)` may also be called
in-process."""
