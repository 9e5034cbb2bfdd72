#!/usr/bin/env python3
"""Drive crackle_tpu_torch's main path once on one CUDA card.

  python3 chip_smoke.py        # one card

Phases, one line each (phase 8 several):
  1. the card (nvidia-smi name and power limit, torch's device name);
  2. build the CUDA kernels from crackle_tpu_torch/csrc;
  3. each kernel against its plain PyTorch version, bit for bit, on
     the first 32 slices of the 512^3 bench volume and all of the
     256^2 x 128 one (plus the u64 paint and a tile-seam run), timed
     with CUDA events at the 512^3 slice shapes;
  4. the main path: upload_stream of the 512^3 volume to the card and
     decode_window(0, 512, check_crcs=True), labels bit-equal to the
     host decoder (crackle_tpu.decompress on its numpy engine, run in
     a child process: this script imports only the port);
  5. decode_window(100, 164) of the same stream;
  6. the u64 watershed volume and the 256^2 x 128 volume the same way;
  7. a flipped stored CRC word must raise FormatError naming its z;
  8. launch counts of the main path; steady-state time per volume of
     each volume, the time of each stage, and the card's busy share
     over three 512^3 decodes (torch.profiler).

Any failure raises and exits non-zero; without a CUDA device the
script exits 2 and prints no result. The last three lines are the
card's name and power limit, the kernels' JSON and
{"ok": true, "device": {...}}.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import crackle_tpu_torch as ct
from crackle_tpu_torch.kernels import _build, ccl, crc32c, replay
from crackle_tpu_torch.kernels import engine as eng

ROOT = os.path.dirname(os.path.abspath(__file__))
VOL512 = os.path.join(ROOT, "bench_data/connectomics_v2_512x512x512.ckl")
VOL256 = os.path.join(ROOT, "bench_data/connectomics_v2_256x256x128.ckl")
VOLU64 = os.path.join(ROOT, "bench_data/watershed_u64_256x256x128.ckl")

# The host oracle, run in a child process: argv holds pairs of a .ckl
# path and an .npy path, which receives the volume as (sz, sy*sx).
ORACLE = """
import sys
import numpy as np
import crackle_tpu as crackle
from crackle_tpu import native
crackle.codec.set_engine("numpy")
if not native.available():
  sys.exit("the native host decoder is missing")
for src, dst in zip(sys.argv[1::2], sys.argv[2::2]):
  with open(src, "rb") as f:
    vol = crackle.decompress(f.read())
  np.save(dst, np.ascontiguousarray(vol.transpose(2, 1, 0)).reshape(
    vol.shape[2], -1))
"""

KERNELS = [
  # name, source, the TPU kernel it replaces on the 512^3 path (and the
  # 256^2 class's one)
  ("replay_keys", "crackle_tpu_torch/csrc/replay.cu",
   "crackle_tpu/kernels/replay_big.py:177",
   "crackle_tpu/kernels/replay_pallas.py:205"),
  ("replay_positions", "crackle_tpu_torch/csrc/replay.cu",
   "crackle_tpu/kernels/replay_big.py:580",
   "crackle_tpu/kernels/replay_big.py:427, "
   "crackle_tpu/kernels/replay_pallas.py:294"),
  ("paint_vcg", "crackle_tpu_torch/csrc/replay.cu",
   "crackle_tpu/kernels/replay_big.py:720",
   "crackle_tpu/kernels/replay_pallas.py:418"),
  ("ccl_paint", "crackle_tpu_torch/csrc/ccl.cu",
   "crackle_tpu/kernels/ccl_pallas.py:417",
   "crackle_tpu/kernels/ccl_pallas.py:337"),
]


def say(phase, msg):
  print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, reps):
  """Mean device milliseconds of fn() over reps runs, after one warm
  run, with the card synchronised around the timing."""
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


def wall_ms(fn, reps):
  """Host-clock milliseconds of each of reps runs of fn() after one
  warm run, the card synchronised around each."""
  fn()
  torch.cuda.synchronize()
  out = []
  for _ in range(reps):
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    out.append((time.perf_counter() - t0) * 1e3)
  return out


def max_abs(a, b):
  if a.shape != b.shape:
    raise AssertionError(f"shapes differ: {a.shape} vs {b.shape}")
  d = (a.to(torch.int64) - b.to(torch.int64)).abs()
  return float(d.max()) if d.numel() else 0.0


def require_equal(what, a, b):
  err = max_abs(a, b)
  if err != 0:
    n = int((a.to(torch.int64) != b.to(torch.int64)).sum())
    raise AssertionError(f"{what}: {n} entries differ (max |d| {err})")
  return err


def require_labels(what, got, want):
  got = got.cpu().numpy()
  if got.shape != want.shape or got.dtype != want.dtype:
    raise AssertionError(f"{what}: {got.shape} {got.dtype}, want "
                         f"{want.shape} {want.dtype}")
  if not np.array_equal(got, want):
    bad = np.flatnonzero((got != want).any(axis=1))
    raise AssertionError(f"{what}: labels differ on {len(bad)} slices, "
                         f"first {bad[0]}")


def read(path):
  with open(path, "rb") as f:
    return f.read()


def host_oracle(paths):
  """The volumes decoded by crackle_tpu.decompress (numpy engine) in a
  child process, each as (sz, sy*sx), and the seconds it took."""
  t0 = time.perf_counter()
  with tempfile.TemporaryDirectory() as tmp:
    outs = [os.path.join(tmp, f"oracle{i}.npy") for i in range(len(paths))]
    args = [a for pair in zip(paths, outs) for a in pair]
    subprocess.run([sys.executable, "-c", ORACLE, *args], cwd=ROOT,
                   check=True, timeout=600)
    vols = [np.load(o) for o in outs]
  return vols, time.perf_counter() - t0


def compare_kernels(binary, z1, dev, tag, errs):
  """Each kernel against its plain version on the same inputs."""
  inputs = eng.prepare_slice_inputs(binary, 0, z1)
  head = inputs["head"]
  uniq, cum, keys = eng._flat_label_tables(head, binary)
  n_per = cum[1:z1 + 1] - cum[:z1]
  cap_n = eng._next_pow2(max(int(n_per.max()), 8))
  T = eng.plant_table(uniq, cum, keys, 0, z1, cap_n)
  t = eng.params_from_jax(inputs, T, dev)
  sx, sy = head.sx, head.sy
  perm = head.crack_format == ct.CrackFormat.PERMISSIBLE

  k, c = replay.replay_keys(t["packed"], t["nbytes"], t["n_chains"])
  kp, cp = replay.replay_keys_plain(t["packed"], t["nbytes"],
                                    t["n_chains"])
  sk, skp = torch.sort(k, 1).values, torch.sort(kp, 1).values
  e = max(require_equal(f"{tag} keys", k, kp),
          require_equal(f"{tag} sorted keys", sk, skp),
          require_equal(f"{tag} cls", c, cp))
  errs["replay_keys"] = max(errs["replay_keys"], e)

  ids = replay.replay_positions(skp, cp, t["nodes"], sx, sy)
  idsp = replay.replay_positions_plain(skp, cp, t["nodes"], sx, sy)
  e = require_equal(f"{tag} edge ids (sets per slice)",
                    torch.sort(ids, 1).values, torch.sort(idsp, 1).values)
  errs["replay_positions"] = max(errs["replay_positions"], e)

  v = replay.paint_vcg(idsp, sx, sy, perm)
  vp = replay.paint_vcg_plain(idsp, sx, sy, perm)
  errs["paint_vcg"] = max(errs["paint_vcg"],
                          require_equal(f"{tag} vcg", v, vp))

  Tt = t["T"]
  cc, N, pt = ccl.ccl_paint(vp, Tt)
  ccp, Np, ptp = ccl.ccl_paint_plain(vp, Tt)
  cc0, N0, _ = ccl.ccl_paint(vp)
  e = max(require_equal(f"{tag} cc", cc, ccp),
          require_equal(f"{tag} N", N, Np),
          require_equal(f"{tag} painted K={Tt.shape[1]}", pt, ptp),
          require_equal(f"{tag} cc K=0", cc0, ccp),
          require_equal(f"{tag} N K=0", N0, Np))
  errs["ccl_paint"] = max(errs["ccl_paint"], e)
  return t, skp, cp, idsp, vp, sx, sy, perm


def main():
  if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
    return 2
  dev = torch.device("cuda")

  smi = subprocess.run(
    ["nvidia-smi", "--query-gpu=name,power.limit",
     "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
  card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
    "nvidia-smi failed"
  kind = torch.cuda.get_device_name(0)
  say(1, f"card: {card} | torch: {kind} | torch {torch.__version__} "
         f"cuda {torch.version.cuda}")

  t0 = time.perf_counter()
  _build.library()
  say(2, f"built kernels in {time.perf_counter() - t0:.3f} s "
         f"(nvcc {_build.build_seconds:.3f} s)")

  b512, b256, bu64 = read(VOL512), read(VOL256), read(VOLU64)
  errs = {name: 0.0 for name, *_ in KERNELS}
  t0 = time.perf_counter()
  sub = compare_kernels(b512, 32, dev, "512^3[:32]", errs)
  compare_kernels(bu64, 32, dev, "u64[:32]", errs)
  # tile seams: the kernels with a 64-codepoint tile against the plain
  # versions at the default tile, on the 256^2 volume
  _, _, _, _, want, sx, sy, perm = compare_kernels(
    b256, 128, dev, "256^2x128", errs)
  t = eng.params_from_jax(eng.prepare_slice_inputs(b256, 0, 128), None,
                          dev)
  replay.TILE = 64
  try:
    k, c = replay.replay_keys(t["packed"], t["nbytes"], t["n_chains"])
    ids = replay.replay_positions(torch.sort(k, 1).values, c, t["nodes"],
                                  sx, sy)
  finally:
    replay.TILE = 1024
  require_equal("tile-64 vcg", replay.paint_vcg(ids, sx, sy, perm), want)
  say(3, f"kernels bit-equal to their plain versions on 512^3[:32], "
         f"256^2x128, u64[:32] and at tile 64: max_abs_err {errs} "
         f"({time.perf_counter() - t0:.1f} s)")

  # kernel vs plain times at the 512^3 slice shapes (first 32 slices)
  t, skp, cp, idsp, vp, sx, sy, perm = sub
  Tt = t["T"]
  args = {
    "replay_keys": (lambda: replay.replay_keys(
      t["packed"], t["nbytes"], t["n_chains"]), lambda: replay.
      replay_keys_plain(t["packed"], t["nbytes"], t["n_chains"])),
    "replay_positions": (lambda: replay.replay_positions(
      skp, cp, t["nodes"], sx, sy), lambda: replay.replay_positions_plain(
        skp, cp, t["nodes"], sx, sy)),
    "paint_vcg": (lambda: replay.paint_vcg(idsp, sx, sy, perm),
                  lambda: replay.paint_vcg_plain(idsp, sx, sy, perm)),
    "ccl_paint": (lambda: ccl.ccl_paint(vp, Tt),
                  lambda: ccl.ccl_paint_plain(vp, Tt)),
  }
  times = {}
  for name, (kern, plain) in args.items():
    times[name] = (cuda_ms(kern, 10), cuda_ms(plain, 2))

  # 4: the main path
  ct.reset_launches()
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  stream = ct.upload_stream(b512, dev)
  if stream is None:
    raise AssertionError("upload_stream declined the 512^3 volume")
  torch.cuda.synchronize()
  t_up = time.perf_counter() - t0
  t0 = time.perf_counter()
  labels, cc, N = stream.decode_window(0, 512, check_crcs=True)
  torch.cuda.synchronize()
  t_dec = time.perf_counter() - t0
  launches = dict(ct.LAUNCHES)
  head = stream.head
  sx, sy, sz = head.sx, head.sy, head.sz
  if labels.shape != (sz, sx * sy) or labels.dtype != torch.uint32:
    raise AssertionError(f"labels {tuple(labels.shape)} {labels.dtype}")
  (want, want_u64, want_256), t_or = host_oracle([VOL512, VOLU64, VOL256])
  require_labels("512^3", labels, want)
  say(4, f"512^3 u32 (CAP {stream.packed.shape[1] * 4}, "
         f"{stream.nbytes_device} bytes on the card): upload_stream "
         f"{t_up * 1e3:.3f} ms, first decode_window(0, 512, "
         f"check_crcs=True) {t_dec * 1e3:.3f} ms, labels bit-equal to the "
         f"host decoder (child process, {t_or:.1f} s for three volumes), "
         f"max N {int(N.max())}")
  del labels, cc

  # 5: a window
  lw, _, _ = stream.decode_window(100, 164, check_crcs=True)
  require_labels("decode_window(100, 164)", lw, want[100:164])
  say(5, "decode_window(100, 164, check_crcs=True) bit-equal")
  del want, lw

  # 6: u64 labels (K = 2), and the 256^2 class of the replay
  small = {}
  for tag, binary, ref, dtype in (("u64 256^2x128", bu64, want_u64,
                                   torch.uint64),
                                  ("u32 256^2x128", b256, want_256,
                                   torch.uint32)):
    t0 = time.perf_counter()
    s = ct.upload_stream(binary, dev)
    if s is None:
      raise AssertionError(f"upload_stream declined the {tag} volume")
    torch.cuda.synchronize()
    t_up_s = time.perf_counter() - t0
    lab, _, _ = s.decode_window(0, s.head.sz, check_crcs=True)
    if lab.dtype != dtype:
      raise AssertionError(f"{tag}: labels {lab.dtype}, want {dtype}")
    require_labels(tag, lab, ref)
    small[tag] = s
    say(6, f"{tag} (CAP {s.packed.shape[1] * 4}): upload_stream "
           f"{t_up_s * 1e3:.3f} ms, labels bit-equal to the host decoder")
  del want_u64, want_256

  # 7: a flipped stored CRC word
  z_bad = 317
  good = stream.crcs.clone()
  stream.crcs[z_bad] ^= 1
  try:
    stream.decode_window(0, 512, check_crcs=True)
    raise AssertionError("flipped CRC word not caught")
  except ct.FormatError as exc:
    if f"z={z_bad}" not in str(exc):
      raise AssertionError(f"wrong slice named: {exc}") from exc
    say(7, f"flipped CRC word caught: {exc}")
  stream.crcs = good

  # 8: launches, steady state, stages, busy share
  missing = [k for k, n in launches.items() if n <= 0]
  say(8, f"main-path launches {launches}")
  if missing:
    raise AssertionError(f"kernels not launched on the main path: {missing}")
  vols = [("512^3", stream)] + list(small.items())
  for tag, s in vols:
    h = s.head
    ms = wall_ms(lambda: s.decode_window(0, h.sz, check_crcs=True), 5)
    mean = sum(ms) / len(ms)
    say(8, f"steady {tag} decode_window(0, {h.sz}, check_crcs=True) ms: "
           + ", ".join(f"{m:.3f}" for m in ms)
           + f"; mean {mean:.3f} ms, {h.sx * h.sy * h.sz / mean / 1e3:.1f} "
             "MVx/s")
  stages = stage_times(stream)
  say(8, "512^3 stage ms at B=512 (CUDA events): " + ", ".join(
    f"{k} {v:.3f}" for k, v in stages.items())
      + f"; sum {sum(stages.values()):.3f}")
  for name, (km, pm) in times.items():
    say(8, f"{name}: kernel {km:.4f} ms, plain {pm:.4f} ms "
           f"(B=32 slices of 512^3)")
  say(8, busy_share(stream))

  if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
    raise AssertionError("jax was imported")

  out = []
  for name, src, repl, also in KERNELS:
    out.append({"name": name, "route": "cuda", "source": src,
                "replaces": repl, "also_replaces": also,
                "launches": launches[name], "max_abs_err": errs[name],
                "ms": times[name][0], "plain_ms": times[name][1],
                "timed_batch": 32})
  print(card)
  print(json.dumps({"kernels": out}))
  print(json.dumps({"ok": True, "device": {
    "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
  return 0


def stage_times(s):
  """Device ms of each stage of one full-volume decode."""
  h = s.head
  keys, cls = replay.replay_keys(s.packed, s.nbytes, s.n_chains)
  skeys = torch.sort(keys, 1).values
  ids = replay.replay_positions(skeys, cls, s.nodes, h.sx, h.sy)
  vcg = replay.paint_vcg(ids, h.sx, h.sy, s.permissible)
  cc, _, _ = ccl.ccl_paint(vcg, s.T)
  return {
    "replay_keys": cuda_ms(lambda: replay.replay_keys(
      s.packed, s.nbytes, s.n_chains), 3),
    "sort": cuda_ms(lambda: torch.sort(keys, 1), 3),
    "replay_positions": cuda_ms(lambda: replay.replay_positions(
      skeys, cls, s.nodes, h.sx, h.sy), 3),
    "paint_vcg": cuda_ms(lambda: replay.paint_vcg(
      ids, h.sx, h.sy, s.permissible), 3),
    "ccl_paint": cuda_ms(lambda: ccl.ccl_paint(vcg, s.T), 3),
    "crc32c": cuda_ms(lambda: crc32c.crc32c_rows(cc), 3),
  }


def busy_share(s):
  """The union of device-activity intervals that torch.profiler
  records over three full decodes, against their host-clock time."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile
  reps = 3
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    for _ in range(reps):
      s.decode_window(0, s.head.sz, check_crcs=True)
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
  spans = sorted((e.time_range.start, e.time_range.end)
                 for e in prof.events() if e.device_type == DeviceType.CUDA)
  if not spans:
    return "512^3 device busy share: not measured (no device events)"
  busy, (lo, hi) = 0, spans[0]
  for a, b in spans[1:]:
    if a > hi:
      busy, lo = busy + hi - lo, a
    hi = max(hi, b)
  busy += hi - lo
  return (f"512^3 device busy share over {reps} decodes: "
          f"{100 * busy / wall_us:.1f}% ({busy / 1e3:.3f} ms of device "
          f"activity in {wall_us / 1e3:.3f} ms, {len(spans)} device events)")


if __name__ == "__main__":
  sys.exit(main())
