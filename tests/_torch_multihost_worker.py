"""One rank of tests/test_torch_multihost.py's two-process run:

  python tests/_torch_multihost_worker.py RANK WORLD PORT DIR [DEVICE]

It imports torch and crackle_tpu_torch only; DEVICE (default cpu) is
where its shards, its encode and its decode run. DIR holds the parent's
reference files: vol.npy (the volume), full.ckl (crackle_tpu.compress of
it) and ref.npz (cc, counts and z_index of crackle_tpu's
sharded_roundtrip_step on a 4-device mesh). Over a gloo group of WORLD
ranks, each rank with a mesh of two shards on DEVICE:
  1. compress_shard of its host_z_window as a tensor on DEVICE under
     set_engine('torch'), equal to compress_sharded of the same window
     (numpy) on its mesh;
  2. after a barrier, rank 0 splices the shards (assemble_shards), which
     must give full.ckl's bytes;
  3. decompress_shard of its window of full.ckl under set_engine('torch')
     on DEVICE, against the volume;
  4. an all_gather of the ranks' label histograms and their uniques,
     against the whole volume's;
  5. sharded_roundtrip_step across the ranks (WORLD x 2 shards), cc,
     counts and z_index against ref.npz, then again with every window
     boundary one row on (ranks with unequal rows).
"""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from crackle_tpu_torch import codec  # noqa: E402
from crackle_tpu_torch.kernels import engine  # noqa: E402
from crackle_tpu_torch.parallel import multihost, sharding  # noqa: E402


def gather(t):
  out = [torch.zeros_like(t) for _ in range(dist.get_world_size())]
  dist.all_gather(out, t)
  return out


def main():
  rank, world, port, tmp = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                            sys.argv[4])
  dev = sys.argv[5] if len(sys.argv) > 5 else "cpu"
  multihost.init_distributed(f"localhost:{port}", world, rank,
                             backend="gloo")
  assert dist.get_world_size() == world and dist.get_rank() == rank
  vol = np.load(os.path.join(tmp, "vol.npy"))
  with open(os.path.join(tmp, "full.ckl"), "rb") as f:
    full = f.read()
  ref = np.load(os.path.join(tmp, "ref.npz"))
  sx, sy, sz = vol.shape
  mesh = sharding.make_mesh([dev] * 2, group=dist.group.WORLD)

  z0, z1 = multihost.host_z_window(sz, world, rank)
  window = np.asfortranarray(vol[:, :, z0:z1])
  codec.set_engine("torch", device=dev)
  shard = multihost.compress_shard(
    torch.from_numpy(window.view(np.int32)).to(dev).view(torch.uint32))
  assert sharding.compress_sharded(window, mesh) == shard, \
    "compress_sharded != compress_shard"
  with open(os.path.join(tmp, f"shard_{rank}.ckl"), "wb") as f:
    f.write(shard)
  dist.barrier()
  if rank == 0:
    parts = []
    for r in range(world):
      with open(os.path.join(tmp, f"shard_{r}.ckl"), "rb") as f:
        parts.append(f.read())
    assert multihost.assemble_shards(parts) == full, \
      "assembled stream != single-process bytes"
  dist.barrier()

  out, (a, b) = multihost.decompress_shard(full, world, rank)
  codec.set_engine("auto")
  assert (a, b) == (z0, z1)
  np.testing.assert_array_equal(out, vol[:, :, a:b])

  hist = torch.from_numpy(np.bincount(window.ravel(), minlength=8)
                          .astype(np.int64))
  got = torch.stack(gather(hist)).sum(0).numpy()
  np.testing.assert_array_equal(got, np.bincount(vol.ravel(), minlength=8))
  uniq = torch.from_numpy(np.pad(np.unique(window).astype(np.int64),
                                 (0, 8))[:8])
  merged = multihost.merged_unique([u.numpy() for u in gather(uniq)])
  assert set(np.unique(vol).tolist()) <= set(merged.tolist())

  head = codec.header(full)
  _, cum, keys = engine._flat_label_tables(head, full)
  step = sharding.sharded_roundtrip_step(
    mesh, sx, sy, permissible=head.crack_format == 1)
  # each rank's window, then the windows with every boundary one row on
  for w0, w1 in ((z0, z1), (z0 + (rank > 0), min(z1 + 1, sz))):
    inputs = engine.prepare_slice_inputs(full, w0, w1)
    cc, counts, z_index = step(inputs["packed"], inputs["nbytes"],
                               inputs["nodes"], inputs["n_chains"], keys,
                               cum[w0:w1])
    np.testing.assert_array_equal(cc.cpu().numpy(), ref["cc"][w0:w1])
    np.testing.assert_array_equal(counts.cpu().numpy(), ref["counts"])
    np.testing.assert_array_equal(z_index.cpu().numpy(), ref["z_index"])

  loaded = [m for m in sys.modules if m.split(".")[0] in ("jax",
                                                          "crackle_tpu")]
  assert not loaded, f"the worker imported the reference: {loaded}"
  dist.destroy_process_group()
  print(f"worker {rank} OK", flush=True)


if __name__ == "__main__":
  main()
