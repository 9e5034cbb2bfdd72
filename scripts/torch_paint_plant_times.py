#!/usr/bin/env python3
"""Time paint_vcg and plant on one CUDA card at B = 1, 32 and 512 slices
of the 512^3 bench volume, each against its bound, and the grid knobs
of the paint and plant kernels.

  python3 scripts/torch_paint_plant_times.py [--tree DIR] [--sweep]

--tree DIR imports crackle_tpu_torch from DIR (a checkout of another
commit, whose kernels build into DIR/build), so that two designs are
timed by the same script on the same card: run it for each tree in
turns. --sweep also times the kernels of this tree at other values of
replay.PAINT_FILL, replay.PAINT_MIN_BAND and ccl.PLANT_FILL.

The inputs are the port's own: the replay kernels' edge ids of all 512
slices (CAP 32768), their VCG, ccl_min's L and the roots of its tgt
(cap_n the next power of two of the most components a slice), and a
table of random int32 (K = 1). Every timed call is first held bit-equal
to its plain version. B = 1 is the first slice, B = 32 the first 32.
Times are device ms, CUDA events: B = 1 and 32 the mean of 200 launches
in one CUDA graph (after a warm replay), B = 512 the mean of 5 eager
launches after one. The bound is the larger of the bytes (inputs read
once, outputs written once) over 3.35 TB/s and the integer operations
(chip_smoke.py's floor counts) over 67 TOPS. Prints the card's name and
power limit first, then one line a kernel, batch and setting. Exits 2
without a CUDA device. Imports nothing of JAX or crackle_tpu.
"""
import argparse
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOL512 = os.path.join(ROOT, "bench_data", "connectomics_v2_512x512x512.ckl")
MEM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
OPS_PER = {"paint_vcg": 15, "plant": 30}


def graph_ms(fn, reps):
  fn()
  torch.cuda.synchronize()
  g = torch.cuda.CUDAGraph()
  with torch.cuda.graph(g, capture_error_mode="relaxed"):
    for _ in range(reps):
      fn()
  g.replay()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  g.replay()
  end.record()
  torch.cuda.synchronize()
  del g
  return start.elapsed_time(end) / reps


def eager_ms(fn, reps):
  fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / reps


def nbytes(*ts):
  return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound_ms(name, nb, elems):
  return 1e3 * max(nb / MEM_BYTES_PER_S, OPS_PER[name] * elems / OPS_PER_S)


def inputs(dev):
  import crackle_tpu_torch as ct
  from crackle_tpu_torch.kernels import ccl, replay
  from crackle_tpu_torch.kernels import engine as eng
  with open(VOL512, "rb") as f:
    binary = f.read()
  head = ct.header(binary)
  t = eng.params_from_jax(eng.prepare_slice_inputs(binary, 0, head.sz),
                          None, dev)
  sx, sy = head.sx, head.sy
  perm = head.crack_format == ct.CrackFormat.PERMISSIBLE
  ev, cls, dr = replay.replay_keys(t["packed"], t["nbytes"], t["n_chains"])
  ids = replay.replay_positions(ev, cls, dr, t["nodes"], sx, sy)
  vcg = replay.paint_vcg(ids, sx, sy, perm)
  L, tgt = ccl.ccl_min(vcg)
  cap2 = ccl._pow2_cap(int((tgt.amax((1, 2)) + 1).max()))
  roots, _ = ccl.roots_from_tgt(tgt, cap2)
  rng = np.random.RandomState(1)
  T = torch.from_numpy(rng.randint(-2 ** 31, 2 ** 31, (head.sz, 1, cap2),
                                   dtype=np.int64).astype(np.int32)).to(dev)
  return ids, sx, sy, perm, L, roots, T


def require_equal(what, got, want):
  for g, w in zip(got, want):
    if not torch.equal(g, w):
      raise AssertionError(f"{what}: the kernel differs from its plain "
                           f"version")


def rows(tag, ids, sx, sy, perm, L, roots, T):
  """One line a kernel and batch at the current settings."""
  from crackle_tpu_torch.kernels import ccl, replay
  out = []
  n = sx * sy
  for B in (1, 32, 512):
    i, l, r, t = (x[:B].contiguous() for x in (ids, L, roots, T))
    timer = (lambda fn: graph_ms(fn, 200)) if B < 512 else \
      (lambda fn: eager_ms(fn, 5))
    runs = {
      "paint_vcg": (lambda: [replay.paint_vcg(i, sx, sy, perm)],
                    lambda: [replay.paint_vcg_plain(i, sx, sy, perm)],
                    nbytes(i) + B * n * 4, i.numel() + B * n),
      "plant K=0": (lambda: ccl.plant(l, r),
                    lambda: ccl.plant_plain(l, r, None),
                    nbytes(l, r) + B * n * 4, B * n),
      "plant K=1": (lambda: ccl.plant(l, r, t),
                    lambda: ccl.plant_plain(l, r, t),
                    nbytes(l, r, t) + B * n * 8, B * n),
    }
    for name, (kern, plain, nb, elems) in runs.items():
      require_equal(f"{tag} {name} B={B}", kern(), plain())
      ms = timer(kern)
      bms = bound_ms(name.split()[0], nb, elems)
      out.append(f"{tag} | {name} B={B}: {ms:.4f} ms, bound "
                 f"{bms * 1e3:.2f} us ({nb} bytes), {100 * bms / ms:.1f}% "
                 f"of the bound")
  return out


def main():
  ap = argparse.ArgumentParser()
  ap.add_argument("--tree", default=ROOT)
  ap.add_argument("--sweep", action="store_true")
  args = ap.parse_args()
  if not torch.cuda.is_available():
    print("torch.cuda.is_available() is False", file=sys.stderr)
    return 2
  tree = os.path.abspath(args.tree)
  sys.path.insert(0, tree)
  from crackle_tpu_torch.kernels import _build, ccl, replay
  if not _build.CSRC.startswith(tree):
    raise AssertionError(f"imported {_build.CSRC}, not {tree}")
  smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
  print(smi.stdout.strip().splitlines()[0], flush=True)
  dev = torch.device("cuda")
  args_ = inputs(dev)
  name = os.path.relpath(tree, ROOT)
  for line in rows(f"tree {name}", *args_):
    print(line, flush=True)
  if not args.sweep:
    return 0
  settings = [("PAINT_FILL", replay, v) for v in (1, 3, 4)]
  settings += [("PAINT_MIN_BAND", replay, v) for v in (512, 2048, 4096)]
  settings += [("PLANT_FILL", ccl, v) for v in (4, 16)]
  for knob, mod, value in settings:
    old = getattr(mod, knob)
    setattr(mod, knob, value)
    try:
      for line in rows(f"{knob}={value}", *args_):
        print(line, flush=True)
    finally:
      setattr(mod, knob, old)
  return 0


if __name__ == "__main__":
  sys.exit(main())
