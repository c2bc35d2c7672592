"""Command-line entry points: `python -m dfu3d_tpu_torch.tools.create_infos`,
`.train` and `.test` (pipelines 3 and 4), `.complete_depth` and
`.generate_pseudo_boxes` (pipeline 2). Each module's `main(argv=None)` may
also be called in-process."""
