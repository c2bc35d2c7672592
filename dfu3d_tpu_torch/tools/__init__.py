"""Command-line entry points: `python -m dfu3d_tpu_torch.tools.create_infos`,
`.train` and `.test`. Each module's `main(argv=None)` may also be called
in-process."""
