"""Pipeline 2 of DFU3D on PyTorch: data-level LiDAR-camera fusion into
pseudo-boxes (`factory.PseudoBoxFactory` over the device programs of `ops`),
the SEEM artifact adapter and synthetic scenes."""
