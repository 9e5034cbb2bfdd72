"""Multi-host orchestration for huge volumes.

Counterpart of crackle_tpu/parallel/multihost.py, with torch.distributed
in place of jax.distributed. z-slices are independent streams, so hosts
own disjoint z windows. Within a host, slices shard over its devices
(sharding.py); across hosts the only communication is:

  * the label dictionary (per-host uniques -> global sorted unique),
  * per-slice byte lengths for the z index (all_gather in z order),
  * the final byte splice on the writer host.

The z index gives O(1) slice location, so every host reads exactly its
window's crack bytes, and zstack's byte-equality guarantee makes a volume
built host by host byte-identical to one compressed in a single process.
On one process these helpers are plain calls.
"""
from typing import Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

from .. import codec as _codec
from .. import operations as _ops


def host_z_window(sz: int, num_hosts: int, host_id: int) -> Tuple[int, int]:
  """Contiguous z-window owned by a host: ceil-division blocks."""
  block = -(-sz // num_hosts)
  z0 = min(host_id * block, sz)
  z1 = min(z0 + block, sz)
  return z0, z1


def compress_shard(labels_window, **kwargs) -> bytes:
  """Compress one host's z-window (a standalone .ckl stream) with
  codec.compress: labels on a card encode there."""
  return _codec.compress(labels_window, **kwargs)


def assemble_shards(shards: Sequence[bytes]) -> bytes:
  """Splice per-host streams into one volume stream (writer host).

  Pure byte surgery via zstack: crack codes and crcs are reused
  byte-for-byte; only the label dictionary is merged. The result is
  byte-identical to single-process compression of the full volume.
  """
  return _ops.zstack(list(shards))


def decompress_shard(binary: bytes, num_hosts: int, host_id: int,
                     mesh=None) -> Tuple[np.ndarray, Tuple[int, int]]:
  """Decode this host's z-window of a full-volume stream with
  codec.decompress_range (on the card under set_engine('torch')). Every
  host parses the (small) header, z index and labels and reads only its
  own crack bytes. mesh is taken and unused, as in the reference
  (crackle_tpu/parallel/multihost.py:54-64)."""
  head = _codec.header(binary)
  z0, z1 = host_z_window(head.sz, num_hosts, host_id)
  if z0 >= z1:
    return (np.zeros((head.sx, head.sy, 0), dtype=head.dtype), (z0, z1))
  out = _codec.decompress_range(binary, z0, z1, 0)
  return out, (z0, z1)


def merged_unique(per_host_uniques: Sequence[np.ndarray]) -> np.ndarray:
  """Global sorted label dictionary from per-host uniques (the
  all_gather + sort/unique step; host-side because dictionaries are
  tiny relative to voxel data)."""
  return np.unique(np.concatenate([np.asarray(u) for u in per_host_uniques]))


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: str = "nccl") -> None:
  """Join the default process group of num_processes ranks as rank
  process_id, through the TCP store at coordinator_address ("host:port",
  rank 0 serving it). A no-op for one process or where a group is
  already initialized; a failed init raises."""
  if num_processes is None or num_processes <= 1 or dist.is_initialized():
    return
  dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                          world_size=num_processes, rank=process_id)
