"""The port's multi-host helpers (crackle_tpu_torch/parallel/multihost.py)
against crackle_tpu.parallel.multihost, and a two-process run over a
gloo group (tests/_torch_multihost_worker.py)."""
import os
import socket
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.distributed as dist

import crackle_tpu as crackle
from crackle_tpu import parallel as rpar
from crackle_tpu.kernels import engine as reng
from crackle_tpu.parallel import multihost as rmh
from crackle_tpu_torch.kernels import engine as teng
from crackle_tpu_torch.parallel import multihost as tmh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
  s = socket.socket()
  s.bind(("localhost", 0))
  port = s.getsockname()[1]
  s.close()
  return port


def test_host_z_window_matches_reference():
  for sz in (0, 1, 7, 12, 13, 64):
    for hosts in (1, 2, 3, 5, 8, 16):
      windows = [tmh.host_z_window(sz, hosts, h) for h in range(hosts)]
      assert windows == [rmh.host_z_window(sz, hosts, h)
                         for h in range(hosts)]
      assert windows[0][0] == 0 and windows[-1][1] == sz
      assert all(a[1] == b[0] for a, b in zip(windows, windows[1:]))


def test_merged_unique_matches_reference():
  parts = [np.array([5, 1, 9], np.uint32), np.array([], np.uint32),
           np.array([9, 2, 2, 70000], np.uint32)]
  got = tmh.merged_unique(parts)
  np.testing.assert_array_equal(got, rmh.merged_unique(parts))
  np.testing.assert_array_equal(got, [1, 2, 5, 9, 70000])


def test_init_distributed_is_a_no_op_for_one_process(monkeypatch):
  def fail(*a, **k):
    raise AssertionError("init_process_group called")

  monkeypatch.setattr(dist, "init_process_group", fail)
  tmh.init_distributed()
  tmh.init_distributed("localhost:1", 1, 0, backend="gloo")
  assert not dist.is_initialized()


def test_init_distributed_raises_when_init_fails(monkeypatch):
  seen = {}

  def fail(backend, **kw):
    seen.update(kw, backend=backend)
    raise RuntimeError("no rendezvous")

  monkeypatch.setattr(dist, "init_process_group", fail)
  with pytest.raises(RuntimeError, match="no rendezvous"):
    tmh.init_distributed("localhost:29500", 2, 1, backend="gloo")
  assert seen == {"backend": "gloo", "init_method": "tcp://localhost:29500",
                  "world_size": 2, "rank": 1}


def test_decompress_shard_matches_reference():
  rng = np.random.RandomState(4)
  vol = np.asfortranarray(rng.randint(0, 5, (10, 9, 7)).astype(np.uint16))
  binary = crackle.compress(vol)
  for hosts in (1, 2, 3, 8):
    for h in range(hosts):
      got, win = tmh.decompress_shard(binary, hosts, h)
      want, rwin = rmh.decompress_shard(binary, hosts, h)
      assert win == rwin and got.dtype == want.dtype
      np.testing.assert_array_equal(got, want)


def test_compress_and_assemble_shards_match_reference():
  rng = np.random.RandomState(5)
  vol = rng.randint(0, 6, (16, 12, 9)).astype(np.uint32)
  for _ in range(5):
    vol = np.where(rng.rand(*vol.shape) < 0.6,
                   np.roll(vol, 1, axis=rng.randint(0, 3)), vol)
  vol = np.asfortranarray(vol)
  windows = [tmh.host_z_window(9, 3, h) for h in range(3)]
  shards = [tmh.compress_shard(np.asfortranarray(vol[:, :, a:b]))
            for a, b in windows]
  assert shards == [rmh.compress_shard(np.asfortranarray(vol[:, :, a:b]))
                    for a, b in windows]
  assert tmh.assemble_shards(shards) == rmh.assemble_shards(shards) \
    == crackle.compress(vol)


def test_one_rank_gloo_group_runs_the_collectives(monkeypatch):
  """With a group of one rank the step's all_reduce and
  all_gather_into_tensor still run (gloo: on the CPU) and change
  nothing."""
  from crackle_tpu_torch.parallel import sharding as tsh
  rng = np.random.RandomState(6)
  vol = np.asfortranarray(rng.randint(0, 4, (12, 10, 7)).astype(np.uint32))
  binary = crackle.compress(vol)
  head = crackle.header(binary)
  inputs = teng.prepare_slice_inputs(binary, 0, 7)
  _, cum, keys = teng._flat_label_tables(head, binary)
  args = [inputs[k] for k in ("packed", "nbytes", "nodes", "n_chains")] + [
    keys, cum[:7]]
  want = tsh.sharded_roundtrip_step(tsh.make_mesh(["cpu"] * 3), 12, 10,
                                    head.crack_format == 1)(*args)
  calls = []
  for name in ("all_reduce", "all_gather_into_tensor"):
    def spy(*a, _f=getattr(dist, name), _n=name, **k):
      calls.append((_n, a[-1].device.type))
      return _f(*a, **k)
    monkeypatch.setattr(dist, name, spy)
  dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                          f"{_free_port()}", world_size=1, rank=0)
  try:
    m = tsh.make_mesh(["cpu"] * 3, group=dist.group.WORLD)
    got = tsh.sharded_roundtrip_step(m, 12, 10, head.crack_format == 1)(*args)
  finally:
    dist.destroy_process_group()
  assert sorted(set(calls)) == [("all_gather_into_tensor", "cpu"),
                                ("all_reduce", "cpu")]
  for g, w in zip(got, want):
    assert g.dtype == w.dtype
    np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_parallel_imports_no_reference():
  code = ("import sys\n"
          "import crackle_tpu_torch.parallel, crackle_tpu_torch.operations\n"
          "from crackle_tpu_torch.parallel import multihost, sharding\n"
          "print(sorted(m for m in sys.modules if m.split('.')[0] in "
          "('jax', 'crackle_tpu')))\n")
  env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
  env["PYTHONPATH"] = ROOT
  res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, env=env, timeout=120)
  assert res.returncode == 0, res.stderr
  assert res.stdout.strip() == "[]"


def run_two_ranks(device: str):
  """Two ranks of tests/_torch_multihost_worker.py over a gloo group,
  each with two shards on `device`, against crackle_tpu's bytes and its
  sharded_roundtrip_step on a 4-device mesh (the same 2 x 2 layout)."""
  rng = np.random.RandomState(0)
  vol = rng.randint(0, 6, size=(24, 20, 12)).astype(np.uint32)
  for _ in range(6):
    axis = rng.randint(0, 3)
    m = rng.rand(*vol.shape) < 0.6
    vol = np.where(m, np.roll(vol, 1, axis=axis), vol)
  vol = np.asfortranarray(vol)
  full = crackle.compress(vol)
  head = crackle.header(full)
  inputs = reng.prepare_slice_inputs(full, 0, 12)
  _, cum, keys = teng._flat_label_tables(head, full)
  step = rpar.sharded_roundtrip_step(rpar.make_mesh(jax.devices()[:4]), 24,
                                     20, permissible=head.crack_format == 1)
  cc, counts, z_index = step(
    *[jnp.asarray(inputs[k]) for k in ("packed", "nbytes", "nodes",
                                       "n_chains")],
    jnp.asarray(keys.astype(np.int32)), jnp.asarray(cum[:12].astype(np.int32)))

  worker = os.path.join(ROOT, "tests", "_torch_multihost_worker.py")
  env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
  port = str(_free_port())
  with tempfile.TemporaryDirectory() as tmp:
    np.save(os.path.join(tmp, "vol.npy"), vol)
    with open(os.path.join(tmp, "full.ckl"), "wb") as f:
      f.write(full)
    np.savez(os.path.join(tmp, "ref.npz"), cc=np.asarray(cc),
             counts=np.asarray(counts), z_index=np.asarray(z_index))
    procs = [subprocess.Popen([sys.executable, worker, str(r), "2", port, tmp,
                               device],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env, cwd=ROOT)
             for r in range(2)]
    outs = []
    try:
      for p in procs:
        outs.append(p.communicate(timeout=240)[0].decode(errors="replace"))
    finally:
      for p in procs:
        if p.poll() is None:
          p.kill()
          p.wait()
  for r, (p, out) in enumerate(zip(procs, outs)):
    assert p.returncode == 0, f"worker {r} failed:\n{out}"
    assert f"worker {r} OK" in out, out


def test_two_process_gloo_run():
  run_two_ranks("cpu")
