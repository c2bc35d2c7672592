"""Data parallelism over torch.distributed (port of dfu3d_tpu/parallel): one
process per card, one global batch, the JAX package's sharded-step math
(`mesh`)."""
from .distributed import all_gather_objects, destroy_distributed, init_distributed
