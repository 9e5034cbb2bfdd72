"""The codec over several devices and processes, sharded on z
(sharding.py), and the multi-host flow (multihost.py)."""
from .sharding import (
  make_mesh, decompress_sharded, decode_window_ccl_sharded,
  voxel_counts_sharded, sharded_roundtrip_step, compress_sharded,
)
