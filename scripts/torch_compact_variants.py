#!/usr/bin/env python3
"""Time copies of crackle_tpu_torch/csrc/compact.cu with one part of a
kernel taken out, on one CUDA card: what each part of cancel_sums (h)
and replay_positions_compact (j) costs at the batch its path runs.

  python3 scripts/torch_compact_variants.py

Each variant is compact.cu with one edit (VARIANTS), built by nvcc into
build/compact_variants/<name>/ (in parallel, with the port's flags) and
run through the port's own wrappers on the replay_keys outputs and
compact tables of all 512 slices of the 512^3 bench volume (CAP 32768).
A part costs about the kernel's time less the variant's. Only "as is"
is held against the plain versions: the other variants' outputs are
wrong by design. Prints the card's name and power limit, then one line
a variant: device ms of each kernel (CUDA events, mean of 5 launches
after one), twice in turns. Exits 2 without a CUDA device. Imports
nothing of JAX or crackle_tpu.
"""
import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import crackle_tpu_torch as ct  # noqa: E402
from crackle_tpu_torch.kernels import _build, replay  # noqa: E402

SRC = os.path.join(_build.CSRC, "compact.cu")
OUT = os.path.join(ROOT, "build", "compact_variants")
VOL512 = os.path.join(ROOT, "bench_data", "connectomics_v2_512x512x512.ckl")

# name -> (kernel, [(text in compact.cu, its replacement)])
VARIANTS = {
  "as is": ("both", []),
  "h without phase 1 (the counting walk and its fill)": ("h", [(
    "on the way\n  if (walker) {", "on the way\n  if (walker && CAP < 0) {")]),
  "h without phase 3 (the walk that writes the records)": ("h", [(
    "  // 3: the walk that writes the records\n  if (walker) {",
    "  // 3: the walk that writes the records\n  if (walker && CAP < 0) {")]),
  "h without the record stores of phase 3": ("h", [(
    "      if ((e & 1) && k >= 0 && k < R) {",
    "      if ((e & 1) && k >= 0 && k < R && w.slot < -1) {")]),
  "h without phase 1's fill of dest, sumH, sumV": ("h", [(
    "      if (i < s1) {\n        dest[row + i] = -1;",
    "      if (i < -1) {\n        dest[row + i] = -1;")]),
  "j without the table pass": ("j", [(
    "        if (p >= w0 && p < w1)\n",
    "        if (p >= w0 && p < w1 && CAP < 0)\n")]),
  "j without the edge ids (the position itself)": ("j", [(
    "        id[k] = edge_id(pc + run[k] + base - move_delta(cps, sxe), cps, sx,\n"
    "                        sy);",
    "        id[k] = (int)(pc + run[k] + base - move_delta(cps, sxe));")]),
}


def build():
  """name -> the variant's ctypes library, its functions typed as the
  port's."""
  src = open(SRC).read()
  jobs = []
  for i, (name, (_, edits)) in enumerate(VARIANTS.items()):
    text = src
    for old, new in edits:
      if text.count(old) != 1:
        raise AssertionError(f"{name}: the text to edit is not in compact.cu "
                             f"once: {old!r}")
      text = text.replace(old, new)
    d = os.path.join(OUT, str(i))
    os.makedirs(d, exist_ok=True)
    cu, so = os.path.join(d, "compact.cu"), os.path.join(d, "lib.so")
    with open(cu, "w") as f:
      f.write(text)
    cmd = ([_build._nvcc()] + _build.NVCC_FLAGS
           + ["-shared", "-I", _build.CSRC, "-o", so, cu])
    jobs.append((name, so, subprocess.Popen(
      cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
  libs = {}
  for name, so, proc in jobs:
    _, err = proc.communicate()
    if proc.returncode:
      raise AssertionError(f"nvcc failed on {name!r}:\n{err}")
    lib = ctypes.CDLL(so)
    for fn, argtypes in _build._SIGNATURES.items():
      if hasattr(lib, fn):
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    libs[name] = lib
  return libs


def cuda_ms(fn, reps=5):
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


def main():
  if not torch.cuda.is_available():
    print("torch.cuda.is_available() is False", file=sys.stderr)
    return 2
  smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
  print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
        else "nvidia-smi failed", flush=True)
  libs = build()
  dev = torch.device("cuda")
  with open(VOL512, "rb") as f:
    s = ct.upload_stream(f.read(), dev)
  h = s.head
  ev, cls, dr = replay.replay_keys(s.packed, s.nbytes, s.n_chains)
  dense = replay.cancel_sums_plain(ev, cls, dr)
  tables = replay.compact_closes(dense, replay.close_cap(
    ev.shape[1], s.nodes.shape[1]))
  ids = replay.replay_positions_compact_plain(cls, tables, s.nodes, h.sx,
                                              h.sy)
  run = {"h": lambda: replay.cancel_sums(ev, cls, dr),
         "j": lambda: replay.replay_positions_compact(cls, tables, s.nodes,
                                                      h.sx, h.sy)}
  real = _build.library
  for turn in range(2):
    for name, lib in libs.items():
      which = VARIANTS[name][0]
      _build.library = lambda lib=lib: lib
      try:
        ms = {k: cuda_ms(fn) for k, fn in run.items()
              if which in (k, "both")}
        if name == "as is" and not (torch.equal(run["h"](), dense)
                                    and torch.equal(run["j"](), ids)):
          raise AssertionError("the kernels differ from the plain versions")
      finally:
        _build.library = real
      print(f"turn {turn}, {name}: " + ", ".join(
        f"{'cancel_sums' if k == 'h' else 'replay_positions_compact'} "
        f"{v:.4f} ms" for k, v in ms.items())
            + f" (B={ev.shape[0]}, CAP {ev.shape[1]})", flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
