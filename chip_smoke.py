#!/usr/bin/env python3
"""Drive crackle_tpu_torch's paths once on one CUDA card.

  python3 chip_smoke.py        # one card

Phases, one line each (phases 8 to 19 several):
  1. the card (nvidia-smi name and power limit, torch's device name);
  2. build the CUDA kernels from crackle_tpu_torch/csrc;
  3. each kernel against its plain PyTorch version, bit for bit, on
     the first 32 slices of the 512^3 bench volume, all of the 256^2 x
     128 one and of the 256^2 x 128 pins one (plus the u64 paint, a
     tile-seam run of the replay, replay_positions and cancel_sums with
     their depth tables in the scratch tensor, replay_positions_compact
     in windows of 64 positions, and the CCL kernels at a 64-pixel
     tile on the 256^2 x 128 VCG and on a 512^2 snake and checkerboard,
     at both tiles, ccl_min_roots among them); ccl_min ->
     roots_from_tgt -> plant against ccl_paint and the compact-cancel
     kernels' edge ids against replay_positions' on the same inputs.
     Meanwhile two child processes run the host oracle on the port's
     own host layer (crackle_tpu_torch.codec and its native library):
     decompress, the condensed-pins compress of the 512^3 volume, numpy label
     statistics of it and cutouts of the decoded volumes. Kernel,
     plain and library-call times with CUDA events at the 512^3 slice
     shapes, once the children have ended (each kernel and the library
     call over 200 launches in one CUDA graph, and over 10 eager
     launches beside it); paint_vcg and plant also at B = 1 (the first
     slice), checked bit-equal to their plain versions there;
  4. the flat main path: upload_stream of the 512^3 volume and
     decode_window(0, 512, check_crcs=True), labels bit-equal to the
     host decoder, with no call of torch.sort or replay.sorted_keys;
     crc32c_rows on its ids at B = 512, 64 and 1 and as 1024 rows of 64
     words, equal to its plain version (and the slices' to their stored
     words), timed against its bound;
  5. decode_window(100, 164) of the same stream;
  6. the u64 watershed, 256^2 x 128 and markov 256^2 x 128 volumes the
     same way;
  7. a flipped stored CRC word must raise FormatError naming its z;
  8. launch counts of the flat path; steady-state time per volume of
     each volume, the time of each stage, the replay stage against its
     whole-stage bound beside the sort-based design's key sort, each CCL pass's device time
     at B = 512 (torch.profiler, by kernel name, over one ccl_paint and
     one ccl_min call) at the default tile and at smaller ones, the
     flat kernels' shares of their bounds at B = 512, paint_vcg and
     plant (K = 0, 1 and 2) on all 512 slices bit-equal to their plain
     versions, and the card's busy share over three 512^3 decodes
     (torch.profiler);
  9. the compact-cancel path (replay.CANCEL_COMPACT): upload_stream and
     decode_window(0, 512, check_crcs=True) of the 512^3 volume against
     the oracle, with no call of torch.sort or replay.sorted_keys, its
     launch counts, steady times beside the default path's, and its
     stage times against replay_positions', with their shares of the
     bound at B = 512 and at B = 32; how cancel_sums' record stores
     coalesce, and its time at 16 warps a slice and
     replay_positions_compact's at other windows;
 10. the pins path: the 512^3 pins stream and the 256^2 x 128 pins
     volume uploaded and decoded (whole and a window) against the
     oracle, its launch counts, steady times and stage times, and
     ccl_min_roots + plant against ccl_paint twice on the same VCG, and
     the shares of the bound of ccl_min, ccl_min_roots and plant at
     B = 512;
 11. analytics: voxel_counts, centroids and bounding_boxes of the flat
     512^3 stream against the numpy oracle (counts and boxes equal,
     centroids within rtol 1e-12), their wall times, launch counts and
     the slice_stats time per 256-slice window with its bound and share,
     its two passes (torch.profiler) and its time at other band sizes;
 12. CrackleDeviceArray cutouts of the 512^3, u64 and pins 512^3
     streams against the same cutouts of the decoded volumes, and
     check_crcs();
 13. a blocky 1024^2 x 8 volume (the oracle makes it from a seed and
     compresses it flat and with pins): both streams decoded with the
     CRC gate against it (the paint in bands, past one block's shared
     memory), the paint kernel against its plain version on their edge
     ids, and the flat stream's analytics against numpy statistics;
 14. the window-decode entry points: decode_window (whole, [3, 7) and
     the last slice) of the 512^3, u64, 256^2, markov-5 and both pins
     streams, and label= masks of two present labels and an absent one
     on the flat streams, against the oracle; codec.decompress under
     set_engine('torch') of each; no call ends on the host codec;
 15. the long-slice volume (nucleus-like ellipsoids, 2048^2 x 32, made
     by the oracle from a seed): every slice past MAX_DEVICE_CAP
     codepoints and PAINT_CAP_N components, the split into pieces, the
     kernels against their plain versions at its shapes,
     decode_window(check_crcs=True) through the split and the gather
     paint and decode_window_ccl_device against the oracle and the
     stored CRCs, launch counts, MVx/s beside the oracle's host decode,
     stage times and the device memory high-water mark;
 16. the device encode: codec.compress of the labels that
     decode_window(0, 512) of the flat 512^3 stream leaves on the card,
     as their (sx, sy, sz) view, must give the committed stream's bytes,
     the u64 volume's likewise, and the long-slice volume (on the card)
     the oracle child's host compress, every compress with no decline
     logged and ccl_paint launched; the launch counts of the 512^3
     encode, its memory high-water mark, steady times of each beside
     the port's host compress of the same labels in this process, the
     time of stage 1, the fetch and the trace alone and of stage 1's
     parts, and ccl_paint with no table on the encode's VCG at B = 512
     and at the encode's batch against its bound;
 17. the z-sharded codec (crackle_tpu_torch.parallel) on a mesh of every
     card and on 4 shards of the first (3 for an unaligned z):
     decompress_sharded of the flat and pins 512^3, u64, markov-5,
     256^2 x 128 and long-slice 2048^2 x 32 streams (the long slices
     taken whole), voxel_counts_sharded, compress_sharded of labels
     on the card and sharded_roundtrip_step against the oracle and the
     committed bytes, each path's launches checked shard by shard; the
     step through a one-rank NCCL group; two processes on the card over
     gloo (this script run with --rank), and with two cards or more one
     process a card over NCCL; steady times beside the unsharded calls;
 18. the stream operations and analytics under set_engine('torch'),
     against four more oracle children (on set_engine('numpy'), started
     when the first three end and waited for in phase 3, before
     anything is timed): (a) voxel_connectivity_graph, 4- and
     6-connected, of the flat and pins 512^3, markov-5 and u64 256^2 x
     128 and long-slice streams, byte-equal to the host loop, with their
     launches (the replay kernels, and the CCL ones for 6-connectivity),
     no CRC pass, steady ms, MVx/s and the card's busy share; (b)
     structure_equal of an equal and an unequal pair of 512^3 streams;
     (c) contacts of the flat 512^3 (anisotropy (4, 4, 40)), pins 512^3
     and u64 streams, == the host loop's dicts; (d) each (8 labels,
     cropped), array_equal, mode_pooling_2x2x1 and connected_components
     (6 and 26) of the 256^2 x 128 stream, equal to the oracle's; (e)
     remap, renumber, mask and zsplit of 512^3 decoded on the card with
     the CRC gate, equal to the oracle volume edited in numpy. No call
     may decline;
 19. the host arrays, util, the CLI and profiling under
     set_engine('torch'), against the oracle's volume and bytes (a step
     of phase 18's third child), each item's first call checked, then
     timed (steady mean of 3, the busy share of one profiled call) beside
     the card's name and power limit: (a) CrackleArray cutouts of the
     flat 512^3 stream (whole, a box, one z, a z step of 3, after
     [..., np.newaxis]); (b) an int over z 200-264 and an array over a
     box written with __setitem__, the oracle's bytes; (c)
     voxel_counts, centroids and bounding_boxes on the card; (d)
     compressa of the labels and zstack of two CrackleArrays, the
     oracle's bytes, and a cutout across the seam; (e) a cutout of the
     pins stream; (f) CrackleRemoteArray slices of a file, its labels,
     num_labels and `in`; (g) util's save and load, bload, aload, rload
     of .ckl, .ckl.gz and .ckl.xz, and save_numpy; (h) the CLI through
     click's CliRunner with the codec's engine at its default: -i, -l,
     -T, -T of a copy with a flipped crack byte (exit 1, the slice
     named), -d -k and the compress of its .npy, the busy shares of the
     last three in a process of their own (this script run with --busy);
     (i) profiling.trace() of a cutout in a process of its own (this
     script run with --trace), whose Chrome trace must name the kernels
     of each launched wrapper and an annotate span, and
     profiling.timer(sync=tensor) around a decode. The decode kernels
     (and slice_stats) must be launched; no call may decline.

Any failure raises and exits non-zero; without a CUDA device the
script exits 2 and prints no result (run with --rank it is one rank of
phase 17's two-process run, with --trace phase 19's traced cutout, with
--busy phase 19's CLI busy shares), and
it imports nothing of JAX or
of crackle_tpu (it fails if any such module is loaded, here or in the
oracle). The last three lines are the card's name and power limit, the
kernels' JSON (each kernel's launches on its path, its largest
difference from its plain version, its time, the plain version's, the
least time the card could take for its bytes or operations, and a
library call's time where one PyTorch call computes the same function)
and {"ok": true, "device": {...}}.
"""
import json
import logging
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

import crackle_tpu_torch as ct
from crackle_tpu_torch import codec as pcodec
from crackle_tpu_torch import operations as ops
from crackle_tpu_torch import parallel
from crackle_tpu_torch.ops import analytics
from crackle_tpu_torch.parallel import multihost, sharding
from crackle_tpu_torch.kernels import _build, ccl, crc32c, replay, stats
from crackle_tpu_torch.kernels import encode as enc
from crackle_tpu_torch.kernels import decode as dec
from crackle_tpu_torch.kernels import engine as eng

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "bench_data")
VOL512 = os.path.join(DATA, "connectomics_v2_512x512x512.ckl")
VOL256 = os.path.join(DATA, "connectomics_v2_256x256x128.ckl")
VOLU64 = os.path.join(DATA, "watershed_u64_256x256x128.ckl")
VOLMKV = os.path.join(DATA, "connectomics_v2_mkv5_256x256x128.ckl")
VOLPINS = os.path.join(DATA, "connectomics_v2_pins_256x256x128.ckl")

# the seed of the blocky 1024^2 x 8 volume of phase 13
SEED_1024 = 11
# the seed and shape (sx, sy, sz) of the long-slice volume of phase 15
SEED_LONG = 7
SHAPE_LONG = (2048, 2048, 32)

# CrackleDeviceArray cutouts held against the same cutouts of the
# oracle's decoded volume, as the text inside np.s_[...], in forms where
# numpy's indexing and CrackleArray's agree (CrackleArray binds an
# Ellipsis differently; tests/test_torch_host.py holds that case); the
# pins 512^3 stream holds the same volume as the flat one (phase 10
# checks all of it)
CUTOUTS = [("512^3", VOL512, "100:300, 50:450, 200:264"),
           ("512^3", VOL512, ":, :, 5"),
           ("512^3", VOL512, "7"),
           ("u64", VOLU64, "30:200, 0:256, 17:90"),
           ("pins 512^3", VOL512, "0:512, 100:101, 300:420")]

# The host oracle, run in child processes. argv[1] is a JSON spec, each
# key optional:
#   decode:    [ckl, npy or null] pairs; the npy receives the volume as
#              (sz, sy*sx)
#   pins:      [ckl, out]: out receives compress(volume, allow_pins=True)
#   stats:     [ckl, npz]: numpy label statistics of the volume
#   cutouts:   [ckl, key, npy]: the decoded volume of ckl [np.s_[key]]
#   make1024:  [seed, flat, pins, npy, npz]: a blocky 1024^2 x 8 volume
#              made from the seed (blocky_1024), compressed flat and with
#              pins, each stream decompressed and checked against it; npy
#              receives the volume as (sz, sy*sx), npz its statistics
#   long:      [seed, shape, ckl, npy, json]: the long-slice volume
#              (nuclei_volume) compressed flat into ckl, decompressed and
#              checked against it; npy receives it as (sz, sy*sx), json
#              the seconds of each step
#   vcg:       [ckl, connectivity, npy] triples: npy receives
#              operations.voxel_connectivity_graph (the host loop) as
#              (sz, sy, sx) uint8
#   contacts:  [ckl, anisotropy, npz] triples: npz receives
#              operations.contacts as lo, hi (uint64) and area columns
#   each:      [ckl, n, npz]: npz receives analytics.each's cropped image
#              of each of the stream's first n labels, by label
#   array_equal: [ckl, ckl] pairs; json receives their results
#   mode_pooling: [ckl, out]: out receives operations.mode_pooling_2x2x1
#   cc:        [ckl, connectivity, out] triples: out receives
#              operations.connected_components
#   arrays:    [ckl, set_int, set_box, set_data, outs]: phase 19's
#              CrackleArray edits and encodes of the stream: outs[0]
#              receives the stream after [set_int] = 0, outs[1] after
#              [set_box] = volume[set_data], outs[2] compress(volume) and
#              outs[3] zstack of the stream and outs[0]
#   json:      the file that receives the array_equal results and the
#              seconds of each of the steps above
# Each step's end is logged to stderr with the seconds since the start.
# The oracle runs the port's host engine only (set_engine('numpy'), so
# that no stream reaches the card): flat streams through the native
# stream decoder, pins streams through the numpy loop.
ORACLE = r"""
import json
import os
import sys
import time
import numpy as np
from crackle_tpu_torch import codec, native
if not native.available():
  sys.exit("the native host decoder is missing")
codec.set_engine("numpy")
spec = json.loads(sys.argv[1])


def nuclei_volume(sx, sy, sz, seed, pitch=24):
  # nucleus-like ellipsoids on background 0: on a jittered pitch-pixel
  # grid, every third slice from z = -5, a cell is skipped with
  # probability 0.25, else an ellipsoid of xy radius r in [6, 10] and z
  # half-extent hz in [2, 5] paints a new label into the background
  # pixels of the disc of radius r * sqrt(1 - ((z - zc) / (hz + 0.5))^2)
  # on each slice it spans (tests/test_torch_window.py has the same)
  rng = np.random.RandomState(seed)
  vol = np.zeros((sz, sy, sx), np.uint32)
  label = 0
  for z0 in range(-5, sz, 3):
    for gy in range(0, sy, pitch):
      for gx in range(0, sx, pitch):
        if rng.rand() < 0.25:
          continue
        r = rng.randint(6, 11)
        hz = rng.randint(2, 6)
        cx = gx + pitch // 2 + rng.randint(-1, 2)
        cy = gy + pitch // 2 + rng.randint(-1, 2)
        zc = z0 + rng.randint(0, 3)
        label += 1
        y0, y1 = max(cy - r, 0), min(cy + r + 1, sy)
        x0, x1 = max(cx - r, 0), min(cx + r + 1, sx)
        d2 = ((np.arange(y0, y1) - cy)[:, None] ** 2
              + (np.arange(x0, x1) - cx)[None, :] ** 2)
        for z in range(max(zc - hz, 0), min(zc + hz + 1, sz)):
          box = vol[z, y0:y1, x0:x1]
          box[(d2 <= r * r * (1 - ((z - zc) / (hz + 0.5)) ** 2))
              & (box == 0)] = label
  return np.asfortranarray(vol.transpose(2, 1, 0))


def read(path):
  with open(path, "rb") as f:
    return f.read()


def label_stats(vol):
  # per-slice unique labels, counts, coordinate sums and x/y extents,
  # then one merge over the (slice, label) rows
  sx, sy, sz = vol.shape
  p = np.arange(sx * sy)
  X, Y = p % sx, p // sx
  rows = []
  for z in range(sz):
    sl = np.ascontiguousarray(vol[:, :, z].T).ravel()
    u, inv, cnt = np.unique(sl, return_inverse=True, return_counts=True)
    order = np.argsort(inv, kind="stable")
    st = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    xs, ys = X[order], Y[order]
    rows.append(np.stack([
      u.astype(np.int64), cnt, np.add.reduceat(xs, st),
      np.add.reduceat(ys, st), z * cnt, np.minimum.reduceat(xs, st),
      np.maximum.reduceat(xs, st), np.minimum.reduceat(ys, st),
      np.maximum.reduceat(ys, st), np.full(len(u), z)], 1))
  r = np.concatenate(rows)
  uniq, k = np.unique(r[:, 0], return_inverse=True)
  out = {"uniq": uniq}
  for i, name in enumerate(["count", "sum_x", "sum_y", "sum_z"], 1):
    out[name] = np.zeros(len(uniq), np.int64)
    np.add.at(out[name], k, r[:, i])
  for name, col, op, fill in (("min_x", 5, np.minimum, 1 << 62),
                              ("max_x", 6, np.maximum, -1),
                              ("min_y", 7, np.minimum, 1 << 62),
                              ("max_y", 8, np.maximum, -1),
                              ("min_z", 9, np.minimum, 1 << 62),
                              ("max_z", 9, np.maximum, -1)):
    out[name] = np.full(len(uniq), fill, np.int64)
    op.at(out[name], k, r[:, col])
  return out


t0 = time.perf_counter()


def done(step):
  print(f"oracle: {step} at {time.perf_counter() - t0:.1f} s",
        file=sys.stderr, flush=True)


vols = {}
for src, dst in spec.get("decode", []):
  vol = codec.decompress(read(src))
  vols[src] = vol
  if dst:
    np.save(dst, np.ascontiguousarray(vol.transpose(2, 1, 0)).reshape(
      vol.shape[2], -1))
  done(f"decoded {os.path.basename(src)}")
if "pins" in spec:
  src, dst = spec["pins"]
  pins = codec.compress(vols[src], allow_pins=True)
  if codec.header(pins).label_format != 2:
    sys.exit("the pins compress did not write condensed pins")
  with open(dst, "wb") as f:
    f.write(pins)
  done("compressed with pins")
if "stats" in spec:
  src, dst = spec["stats"]
  np.savez(dst, **label_stats(vols[src]))
  done("label statistics")
for src, key, dst in spec.get("cutouts", []):
  np.save(dst, vols[src][eval(f"np.s_[{key}]")])
  done(f"cutout [{key}]")
if "make1024" in spec:
  seed, flat, pins, npy, npz = spec["make1024"]
  rng = np.random.RandomState(seed)
  blocks = rng.randint(0, 40, (17, 17, 8)).astype(np.uint32)
  vol = np.repeat(np.repeat(blocks, 64, 0), 64, 1)
  for z in range(8):
    vol[:, :, z] = np.roll(vol[:, :, z], (5 * z, 3 * z), (0, 1))
  vol = np.asfortranarray(vol[:1024, :1024])
  for dst, allow in ((flat, False), (pins, True)):
    binary = codec.compress(vol, allow_pins=allow)
    if codec.header(binary).label_format != (2 if allow else 0):
      sys.exit(f"the 1024^2 compress (allow_pins={allow}) chose another "
               "label format")
    if not np.array_equal(codec.decompress(binary), vol):
      sys.exit(f"the 1024^2 stream (allow_pins={allow}) does not round-trip")
    with open(dst, "wb") as f:
      f.write(binary)
  np.save(npy, np.ascontiguousarray(vol.transpose(2, 1, 0)).reshape(8, -1))
  np.savez(npz, **label_stats(vol))
  done("1024^2 x 8 flat and pins streams")
if "long" in spec:
  seed, shape, ckl, npy, js = spec["long"]
  secs = {}
  t = time.perf_counter()
  vol = nuclei_volume(*shape, seed)
  secs["make"] = time.perf_counter() - t
  t = time.perf_counter()
  binary = codec.compress(vol)
  secs["compress"] = time.perf_counter() - t
  t = time.perf_counter()
  out = codec.decompress(binary)
  secs["host_decode"] = time.perf_counter() - t
  if codec.header(binary).label_format != 0 or not np.array_equal(out, vol):
    sys.exit("the long-slice stream does not round-trip flat")
  with open(ckl, "wb") as f:
    f.write(binary)
  np.save(npy, np.ascontiguousarray(vol.transpose(2, 1, 0)).reshape(
    shape[2], -1))
  with open(js, "w") as f:
    json.dump(secs, f)
  done("the long-slice volume")
if "arrays" in spec:
  from crackle_tpu_torch import operations
  from crackle_tpu_torch.array import CrackleArray
  src, set_int, set_box, set_data, outs = spec["arrays"]
  b = read(src)
  vol = vols[src] if src in vols else codec.decompress(b)
  edits = [CrackleArray(b), CrackleArray(b)]
  edits[0][eval(f"np.s_[{set_int}]")] = 0
  edits[1][eval(f"np.s_[{set_box}]")] = vol[eval(f"np.s_[{set_data}]")]
  results = [edits[0].binary, edits[1].binary, codec.compress(vol),
             operations.zstack([CrackleArray(b), edits[0]])]
  for dst, binary in zip(outs, results):
    with open(dst, "wb") as f:
      f.write(binary)
  done("CrackleArray edits, compress and zstack")
if "json" in spec:
  from crackle_tpu_torch import operations
  from crackle_tpu_torch.ops import analytics
  out = {"secs": {}, "array_equal": []}

  def timed(step, fn):
    t = time.perf_counter()
    res = fn()
    out["secs"][step] = time.perf_counter() - t
    done(step)
    return res

  for src, c, dst in spec.get("vcg", []):
    v = timed(f"vcg{c} {os.path.basename(src)}",
              lambda: operations.voxel_connectivity_graph(read(src), c))
    np.save(dst, np.ascontiguousarray(v.transpose(2, 1, 0)))
  for src, an, dst in spec.get("contacts", []):
    d = timed(f"contacts {os.path.basename(src)}",
              lambda: operations.contacts(read(src), tuple(an)))
    k = np.array(sorted(d), np.uint64).reshape(-1, 2)
    np.savez(dst, lo=k[:, 0], hi=k[:, 1],
             area=np.array([d[tuple(r)] for r in k.tolist()], np.float64))
  if "each" in spec:
    src, n, dst = spec["each"]
    b = read(src)
    labels = [int(u) for u in codec.labels(b)[:n]]
    imgs = timed("each", lambda: list(analytics.each(b, labels=labels)))
    np.savez(dst, **{str(k): v for k, v in imgs})
  for a, b in spec.get("array_equal", []):
    out["array_equal"].append(timed(
      f"array_equal {os.path.basename(a)} {os.path.basename(b)}",
      lambda: operations.array_equal(read(a), read(b))))
  if "mode_pooling" in spec:
    src, dst = spec["mode_pooling"]
    with open(dst, "wb") as f:
      f.write(timed("mode_pooling_2x2x1", lambda: operations.
                    mode_pooling_2x2x1(read(src))))
  for src, c, dst in spec.get("cc", []):
    with open(dst, "wb") as f:
      f.write(timed(f"connected_components {c}", lambda: operations.
                    connected_components(read(src), c)))
  with open(spec["json"], "w") as f:
    json.dump(out, f)
loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "crackle_tpu")]
if loaded:
  sys.exit(f"the oracle imported the reference: {loaded}")
"""

KERNELS = [
  # name, source, the TPU kernel it replaces on the 512^3 path (and the
  # 256^2 class's one), the path whose run gives its launch count ("" for
  # none: ccl_min, held to the reference's (L, tgt), which no path of the
  # port launches since the pins path takes ccl_min_roots)
  ("replay_keys", "crackle_tpu_torch/csrc/replay.cu",
   "crackle_tpu/kernels/replay_big.py:177",
   "crackle_tpu/kernels/replay_pallas.py:205", "flat"),
  ("replay_positions", "crackle_tpu_torch/csrc/replay.cu",
   "crackle_tpu/kernels/replay_big.py:580",
   "crackle_tpu/kernels/replay_big.py:427, "
   "crackle_tpu/kernels/replay_pallas.py:294", "flat"),
  ("paint_vcg", "crackle_tpu_torch/csrc/replay.cu",
   "crackle_tpu/kernels/replay_big.py:720",
   "crackle_tpu/kernels/replay_pallas.py:418", "flat"),
  ("ccl_paint", "crackle_tpu_torch/csrc/ccl.cu",
   "crackle_tpu/kernels/ccl_pallas.py:417",
   "crackle_tpu/kernels/ccl_pallas.py:337", "flat"),
  ("ccl_min", "crackle_tpu_torch/csrc/ccl.cu",
   "crackle_tpu/kernels/ccl_pallas.py:476", "", ""),
  ("ccl_min_roots", "crackle_tpu_torch/csrc/ccl.cu",
   "crackle_tpu/kernels/ccl_pallas.py:476 and :626 roots_from_tgt (XLA)",
   "", "pins"),
  ("plant", "crackle_tpu_torch/csrc/ccl.cu",
   "crackle_tpu/kernels/ccl_pallas.py:541", "", "pins"),
  ("slice_stats", "crackle_tpu_torch/csrc/stats.cu",
   "crackle_tpu/kernels/stats_pallas.py:46", "", "analytics"),
  ("cancel_sums", "crackle_tpu_torch/csrc/compact.cu",
   "crackle_tpu/kernels/replay_big.py:281", "", "compact"),
  ("compact_closes", "crackle_tpu_torch/csrc/compact.cu",
   "crackle_tpu/kernels/replay_big.py:349", "", "compact"),
  ("replay_positions_compact", "crackle_tpu_torch/csrc/compact.cu",
   "crackle_tpu/kernels/replay_big.py:592", "", "compact"),
  # no Pallas kernel: the TPU computes the CRC gate with XLA matmuls
  ("crc32c_rows", "crackle_tpu_torch/csrc/crc32c.cu",
   "crackle_tpu/kernels/crc32c_tpu.py:171 crc32c_words_traced (XLA)", "",
   "flat"),
]

# the kernels each path must launch
PATHS = {
  "flat": ("replay_keys", "replay_positions", "paint_vcg", "ccl_paint",
           "crc32c_rows"),
  "compact": ("replay_keys", "cancel_sums", "compact_closes",
              "replay_positions_compact", "paint_vcg", "ccl_paint",
              "crc32c_rows"),
  "pins": ("replay_keys", "replay_positions", "paint_vcg", "ccl_min_roots",
           "plant", "crc32c_rows"),
  "analytics": ("replay_keys", "replay_positions", "paint_vcg",
                "ccl_paint", "slice_stats"),
  "encode": ("ccl_paint", "crc32c_rows"),
  # phase 18: the VCG from the replay kernels alone; with 6-connectivity
  # the labels too, from the same VCG
  "vcg4": ("replay_keys", "replay_positions", "paint_vcg"),
  "vcg6": ("replay_keys", "replay_positions", "paint_vcg", "ccl_paint"),
  "vcg6 pins": ("replay_keys", "replay_positions", "paint_vcg",
                "ccl_min_roots", "plant"),
}


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


def graph_ms(fn, reps):
  """Mean device milliseconds of fn() over reps back-to-back runs
  captured in one CUDA graph and replayed once (after a warm replay),
  so that no host time falls between the launches: for kernels of a
  few microseconds, whose wrapper's Python outlasts them."""
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


def device_ms_by_kernel(fn, names):
  """{name: device ms} of one fn() call, summed over the device events
  whose kernel name holds f"{name}_kernel" (torch.profiler); {} where
  the profiler recorded none."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile
  fn()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    fn()
    torch.cuda.synchronize()
  ms = {}
  for e in prof.events():
    hit = [k for k in names if f"{k}_kernel" in e.name]
    if e.device_type == DeviceType.CUDA and hit:
      ms[hit[0]] = ms.get(hit[0], 0.0) + (
        e.time_range.end - e.time_range.start) / 1e3
  return ms


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
    bad = np.flatnonzero((got != want).reshape(len(got), -1).any(axis=1))
    raise AssertionError(f"{what}: labels differ on {len(bad)} rows, "
                         f"first {bad[0]}")


def read(path):
  with open(path, "rb") as f:
    return f.read()


def start_oracle(tmp):
  """Start the host oracle in three child processes, the pins compress
  of the 512^3 volume in one, the long-slice volume in another and the
  rest in the third; returns (the processes, the paths they write)."""
  out = {name: os.path.join(tmp, f"{name}.npy") for name in
         ("512", "u64", "256", "mkv", "pins256")}
  out["pins512"] = os.path.join(tmp, "pins512.ckl")
  out["1024"] = [os.path.join(tmp, f) for f in (
    "flat1024.ckl", "pins1024.ckl", "vol1024.npy", "stats1024.npz")]
  out["long"] = [os.path.join(tmp, f) for f in (
    "long.ckl", "long.npy", "long.json")]
  out["stats"] = os.path.join(tmp, "stats512.npz")
  out["cutouts"] = [os.path.join(tmp, f"cut{i}.npy")
                    for i in range(len(CUTOUTS))]
  specs = [
    {"decode": [[VOL512, None]], "pins": [VOL512, out["pins512"]],
     "make1024": [SEED_1024] + out["1024"]},
    {"decode": [[VOL512, out["512"]], [VOLU64, out["u64"]],
                [VOL256, out["256"]], [VOLMKV, out["mkv"]],
                [VOLPINS, out["pins256"]]],
     "stats": [VOL512, out["stats"]],
     "cutouts": [[src, key, dst] for (_, src, key), dst
                 in zip(CUTOUTS, out["cutouts"])]},
    {"long": [SEED_LONG, SHAPE_LONG] + out["long"]},
  ]
  procs = [subprocess.Popen([sys.executable, "-c", ORACLE, json.dumps(spec)],
                            cwd=ROOT) for spec in specs]
  return procs, out


def plain_table(rng, B, K, cap_n, dev):
  return torch.from_numpy(rng.randint(
    -2 ** 31, 2 ** 31, (B, K, cap_n), dtype=np.int64).astype(np.int32)).to(dev)


def compare_kernels(binary, z1, dev, tag, errs):
  """Each kernel against its plain version on the same inputs."""
  inputs = eng.prepare_slice_inputs(binary, 0, z1)
  head = inputs["head"]
  if head.label_format == 0:
    uniq, cum, keys = eng._flat_label_tables(head, binary)
    n_per = cum[1:z1 + 1] - cum[:z1]
    cap_n = eng._next_pow2(max(int(n_per.max()), 8))
    T = eng.plant_table(uniq, cum, keys, 0, z1, cap_n)
  else:  # pins: any table of the stream's cap_n
    cap_n = eng._pins_device_tables(head, binary, 0, z1)[5]
    T = plain_table(np.random.RandomState(z1), z1, 1, cap_n, "cpu").numpy()
  t = eng.params_from_jax(inputs, T, dev)
  sx, sy = head.sx, head.sy
  perm = head.crack_format == ct.CrackFormat.PERMISSIBLE

  ev, c, dr = replay.replay_keys(t["packed"], t["nbytes"], t["n_chains"])
  evp, cp, drp = replay.replay_keys_plain(t["packed"], t["nbytes"],
                                          t["n_chains"])
  e = max(require_equal(f"{tag} event words", ev, evp),
          require_equal(f"{tag} cls", c, cp),
          require_equal(f"{tag} depth ranges", dr, drp))
  errs["replay_keys"] = max(errs["replay_keys"], e)

  ids = replay.replay_positions(evp, cp, drp, t["nodes"], sx, sy)
  idsp = replay.replay_positions_plain(evp, cp, drp, t["nodes"], sx, sy)
  errs["replay_positions"] = max(errs["replay_positions"], require_equal(
    f"{tag} edge ids", ids, idsp))

  dense = replay.cancel_sums(evp, cp, drp)
  densep = replay.cancel_sums_plain(evp, cp, drp)
  errs["cancel_sums"] = max(errs["cancel_sums"], require_equal(
    f"{tag} dense close records", dense, densep))
  ccap = replay.close_cap(evp.shape[1], t["nodes"].shape[1])
  tables = replay.compact_closes(densep, ccap)
  tablesp = replay.compact_closes_plain(densep, ccap)
  errs["compact_closes"] = max(errs["compact_closes"], require_equal(
    f"{tag} compact tables", tables, tablesp))
  idc = replay.replay_positions_compact(cp, tablesp, t["nodes"], sx, sy)
  idcp = replay.replay_positions_compact_plain(cp, tablesp, t["nodes"], sx,
                                               sy)
  errs["replay_positions_compact"] = max(
    errs["replay_positions_compact"],
    require_equal(f"{tag} compact edge ids", idc, idcp))
  require_equal(f"{tag} compact edge ids vs replay_positions'", idc, ids)

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

  L, tgt = ccl.ccl_min(vp)
  Lp, tgtp = ccl.ccl_min_plain(vp)
  errs["ccl_min"] = max(errs["ccl_min"],
                        require_equal(f"{tag} L", L, Lp),
                        require_equal(f"{tag} tgt", tgt, tgtp))
  cap2 = ccl._pow2_cap(cap_n)
  roots, Nr = ccl.roots_from_tgt(tgtp, cap2)
  for name, a, b in zip(("L", "roots", "N"), ccl.ccl_min_roots(vp, cap2),
                        (Lp, roots, Nr)):
    errs["ccl_min_roots"] = max(errs["ccl_min_roots"], require_equal(
      f"{tag} ccl_min_roots {name}", a, b))
  rng = np.random.RandomState(7)
  for K in (0, 1, 2):
    TK = plain_table(rng, z1, K, cap2, dev) if K else None
    got = ccl.plant(Lp, roots, TK)
    want = ccl.plant_plain(Lp, roots, TK)
    errs["plant"] = max(errs["plant"],
                        require_equal(f"{tag} plant cc K={K}", got[0],
                                      want[0]),
                        require_equal(f"{tag} plant painted K={K}", got[1],
                                      want[1]))
  for name, a, b in zip(("cc", "N", "painted"), ccl.ccl_paint_v2(vp, Tt),
                        (ccp, Np, ptp)):
    require_equal(f"{tag} ccl_paint_v2 {name} vs ccl_paint", a, b)

  errs["crc32c_rows"] = max(errs["crc32c_rows"], require_equal(
    f"{tag} crc32c_rows", crc32c.crc32c_rows(ccp),
    crc32c.crc32c_rows_plain(ccp)))
  cap_s = ccl._pow2_cap(int(Np.max()))
  errs["slice_stats"] = max(errs["slice_stats"], require_equal(
    f"{tag} slice_stats", stats.slice_stats(ccp, sx, sy, cap_s),
    stats.slice_stats_plain(ccp, sx, sy, cap_s)))
  return (t, cp, idsp, vp, sx, sy, perm, Lp, roots, ccp, cap_s, densep,
          tablesp, evp, drp)


def snake_vcg(B, sy, sx):
  """One component through every row: rows linked along x, row y to
  row y - 1 only at its right end (y odd) or its left end (y even)."""
  v = np.zeros((B, sy, sx), np.int32)
  v[:, :, 1:] |= 0b0010
  v[:, :, :-1] |= 0b0001
  ys = np.arange(1, sy)
  xs = np.where(ys % 2 == 1, sx - 1, 0)
  v[:, ys, xs] |= 0b1000
  v[:, ys - 1, xs] |= 0b0100
  return v


def compare_ccl_tiles(vcg, dev, tag, n_want=None):
  """ccl_paint (K = 0 and 1), ccl_min and ccl_min_roots (1024 roots) at
  ccl.TILE_PIX = 64 and at the default tile against the plain versions;
  returns the largest difference. n_want, where given, is every slice's
  component count."""
  T = plain_table(np.random.RandomState(64), vcg.shape[0], 1, 1024, dev)
  cc, N, pt = ccl.ccl_paint_plain(vcg, T)
  if n_want is not None and N.tolist() != [n_want] * len(N):
    raise AssertionError(f"{tag}: N {N.tolist()}, want {n_want}")
  L, tgt = ccl.ccl_min_plain(vcg)
  roots, _ = ccl.roots_from_tgt(tgt, 1024)
  default = ccl.TILE_PIX
  err = 0.0
  for tile in (64, default):
    ccl.TILE_PIX = tile
    try:
      got = (ccl.ccl_paint(vcg, T) + ccl.ccl_paint(vcg)[:2] + ccl.ccl_min(vcg)
             + ccl.ccl_min_roots(vcg, 1024))
    finally:
      ccl.TILE_PIX = default
    for name, a, b in zip(("cc", "N", "painted", "cc K=0", "N K=0", "L",
                           "tgt", "roots' L", "roots", "roots' N"), got,
                          (cc, N, pt, cc, N, L, tgt, L, roots, N)):
      err = max(err, require_equal(f"{tag} tile {tile} {name}", a, b))
  return err


def check_no_reference():
  loaded = [m for m in sys.modules if m.split(".")[0] in ("jax",
                                                          "crackle_tpu")]
  if loaded:
    raise AssertionError(f"the reference was imported: {loaded}")


# The card's published peaks (H100 SXM data sheet): device memory, and
# the 32-bit rate outside the tensor cores, against which the kernels'
# integer operations are counted
MEM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12

# integer operations per element (codepoint, edge id or pixel) of each
# kernel, a floor counted from its source
OPS_PER = {"replay_keys": 40, "replay_positions": 30, "paint_vcg": 15,
           "ccl_paint": 20, "ccl_min": 20, "ccl_min_roots": 20, "plant": 30,
           "slice_stats": 10, "cancel_sums": 50, "compact_closes": 3,
           "replay_positions_compact": 40, "crc32c_rows": 20}


def nbytes_of(*ts):
  return sum(x.numel() * x.element_size() for x in ts)


def compact_closes_io(dense, tables):
  """(bytes, elements) of compact_closes: the dest plane read once, each
  close's pos and sums read once (only the closes these records hold),
  the tables written once."""
  _, B, CAP = dense.shape
  closes = int((dense[0] >= 0).sum())
  return B * CAP * 4 + closes * 12 + nbytes_of(tables), B * CAP


def slice_stats_io(cc, cap_n):
  """(bytes, elements) of slice_stats: the ids read once, the (B, cap_n,
  8) int64 statistics written once."""
  return nbytes_of(cc) + cc.shape[0] * cap_n * 8 * 8, cc.numel()


def crc32c_rows_io(cc):
  """(bytes, elements) of crc32c_rows: the words read once, each row's
  int64 CRC written once (the chunks' partial registers, 4 B a chunk,
  left out)."""
  return nbytes_of(cc) + 8 * cc.shape[0], cc.numel()


def kernel_io(t, cp, idsp, vp, Lp, roots, ccp, cap_s, densep, tablesp,
              evp, drp):
  """name -> (bytes, elements) of each kernel on these inputs: each
  input read once and each output written once; where the work depends
  on the data (the close records a compaction moves), only what these
  inputs need is counted."""
  B, CAP = evp.shape
  npx = vp.numel()
  K = t["T"].shape[1]
  kept = int((tablesp[0] < CAP).sum())
  return {
    "replay_keys": (nbytes_of(t["packed"], t["nbytes"], t["n_chains"], evp,
                              cp, drp), B * CAP),
    "replay_positions": (nbytes_of(evp, cp, drp, t["nodes"], idsp),
                         B * CAP),
    "paint_vcg": (nbytes_of(idsp, vp), B * CAP + npx),
    "ccl_paint": (nbytes_of(vp, t["T"]) + npx * 4 * (1 + K) + B * 4, npx),
    "ccl_min": (nbytes_of(vp) + 2 * npx * 4, npx),
    "ccl_min_roots": (nbytes_of(vp, roots) + npx * 4, npx),
    "plant": (nbytes_of(Lp, roots, t["T"]) + npx * 4 * (1 + K), npx),
    "slice_stats": slice_stats_io(ccp, cap_s),
    "cancel_sums": (nbytes_of(evp, cp, drp, densep), B * CAP),
    "compact_closes": compact_closes_io(densep, tablesp),
    "replay_positions_compact": (nbytes_of(cp, t["nodes"], tablesp[0], idsp)
                                 + kept * 8, B * CAP),
    "crc32c_rows": crc32c_rows_io(ccp),
  }


def bound(name, nbytes, elems):
  """(bytes, ops, bound ms, "bytes" or "operations") of a kernel that
  moves nbytes over elems elements, at any batch: the larger of bytes
  over the memory rate and its operations over the 32-bit rate."""
  ops = OPS_PER[name] * elems
  tb, to = nbytes / MEM_BYTES_PER_S, ops / OPS_PER_S
  return nbytes, ops, 1e3 * max(tb, to), "bytes" if tb >= to else \
    "operations"


def share_line(name, ms, io, batch):
  """name: time, bound and share of the bound at a batch of slices."""
  nb, nops, bms, by = bound(name, *io)
  return (f"{name} {ms:.4f} ms, bound {bms * 1e3:.2f} us by {by} ({nb} "
          f"bytes, {nops} ops; {100 * bms / ms:.1f}% of the bound at "
          f"B={batch})")


def b1_rows(ids, sx, sy, perm, L, roots, T, errs):
  """name -> (ms, plain ms, bound ms, bound by, bytes, ops, 10 eager
  launches' ms) of paint_vcg and plant (K = T's) at B = 1, each first
  held bit-equal to its plain version (errs takes the difference)."""
  errs["paint_vcg"] = max(errs["paint_vcg"], require_equal(
    "B=1 vcg", replay.paint_vcg(ids, sx, sy, perm),
    replay.paint_vcg_plain(ids, sx, sy, perm)))
  for got, want, what in zip(ccl.plant(L, roots, T),
                             ccl.plant_plain(L, roots, T),
                             ("cc", "painted")):
    errs["plant"] = max(errs["plant"], require_equal(f"B=1 plant {what}",
                                                     got, want))
  n = sx * sy
  runs = {
    "paint_vcg": (lambda: replay.paint_vcg(ids, sx, sy, perm),
                  lambda: replay.paint_vcg_plain(ids, sx, sy, perm),
                  (nbytes_of(ids) + n * 4, ids.numel() + n)),
    "plant": (lambda: ccl.plant(L, roots, T),
              lambda: ccl.plant_plain(L, roots, T),
              (nbytes_of(L, roots, T) + n * 4 * (1 + T.shape[1]), n)),
  }
  out = {}
  for name, (kern, plain, io) in runs.items():
    nb, nops, bms, by = bound(name, *io)
    ms10 = cuda_ms(kern, 10)
    out[name] = (graph_ms(kern, 200), cuda_ms(plain, 2), bms, by, nb, nops,
                 ms10)
  return out


def crc_shape_rows(cc, stored, errs):
  """tag -> (ms, plain ms, bound ms, bound by, bytes, ops) of crc32c_rows
  on the ids of a path batch (cc: B = 512 slices of 512^2), its first 64
  slices, its first slice, and 1024 rows of the first slice's first 64K
  words: each first held equal to its plain version (errs takes the
  difference), and the slices' CRCs to their stored words. Timed as at
  B = 32 (200 launches in one CUDA graph) under 4M words, else as a
  path batch's stage (20 eager launches)."""
  B, W = cc.shape
  shapes = {f"{B}x{W}": cc, f"64x{W}": cc[:64], f"1x{W}": cc[:1],
            "1024x64": cc[0, :1024 * 64].reshape(1024, 64)}
  out = {}
  for tag, words in shapes.items():
    words = words.contiguous()
    got = crc32c.crc32c_rows(words)
    e = require_equal(f"{tag} crc32c_rows", got,
                      crc32c.crc32c_rows_plain(words))
    if words.shape[1] == W:
      e = max(e, require_equal(f"{tag} crc32c_rows against the stored words",
                               got, stored[:words.shape[0]]))
    errs["crc32c_rows"] = max(errs["crc32c_rows"], e)

    def kern():
      return crc32c.crc32c_rows(words)

    ms = graph_ms(kern, 200) if words.numel() < 1 << 22 else cuda_ms(kern, 20)
    nb, nops, bms, by = bound("crc32c_rows", *crc32c_rows_io(words))
    out[tag] = (ms, cuda_ms(lambda: crc32c.crc32c_rows_plain(words), 2), bms,
                by, nb, nops)
  return out


def path_batch_equal(s, errs):
  """paint_vcg and plant (K = 0, 1, 2) on every slice of the flat
  stream (the path batch) against their plain versions."""
  h = s.head
  ev, cls, dr = replay.replay_keys(s.packed, s.nbytes, s.n_chains)
  ids = replay.replay_positions(ev, cls, dr, s.nodes, h.sx, h.sy)
  del ev, cls, dr
  vcg = replay.paint_vcg(ids, h.sx, h.sy, s.permissible)
  errs["paint_vcg"] = max(errs["paint_vcg"], require_equal(
    "B=512 vcg", vcg, replay.paint_vcg_plain(ids, h.sx, h.sy,
                                             s.permissible)))
  del ids
  L, tgt = ccl.ccl_min(vcg)
  del vcg
  roots, _ = ccl.roots_from_tgt(tgt, ccl._pow2_cap(int(
    (tgt.amax((1, 2)) + 1).max())))
  del tgt
  rng = np.random.RandomState(512)
  for K in (0, 1, 2):
    T = plain_table(rng, h.sz, K, roots.shape[1], s.device) if K else None
    for got, want, what in zip(ccl.plant(L, roots, T),
                               ccl.plant_plain(L, roots, T),
                               ("cc", "painted")):
      errs["plant"] = max(errs["plant"], require_equal(
        f"B=512 plant K={K} {what}", got, want))
  return (f"paint_vcg and plant (K = 0, 1, 2; cap_n {roots.shape[1]}) on "
          f"all {h.sz} slices bit-equal to their plain versions")


def full_io(s):
  """kernel_io of the whole flat stream (B = sz): each stage's inputs
  and outputs made once by the kernels, and only their sizes kept."""
  h = s.head
  ev, cls, dr = replay.replay_keys(s.packed, s.nbytes, s.n_chains)
  ids = replay.replay_positions(ev, cls, dr, s.nodes, h.sx, h.sy)
  vcg = replay.paint_vcg(ids, h.sx, h.sy, s.permissible)
  cc, N, _ = ccl.ccl_paint(vcg, s.T)
  L, tgt = ccl.ccl_min(vcg)
  cap2 = ccl._pow2_cap(int(N.max()))
  roots, _ = ccl.roots_from_tgt(tgt, cap2)
  del tgt
  dense = replay.cancel_sums(ev, cls, dr)
  tables = replay.compact_closes(dense, replay.close_cap(
    ev.shape[1], s.nodes.shape[1]))
  t = {"packed": s.packed, "nbytes": s.nbytes, "n_chains": s.n_chains,
       "nodes": s.nodes, "T": s.T}
  return kernel_io(t, cls, ids, vcg, L, roots, cc, cap2, dense, tables, ev,
                   dr)


class SortCount:
  """Counts the calls of torch.sort and of replay.sorted_keys (the
  reference's keys, which only cancel_sums' plain version sorts) while
  it is entered."""

  def __enter__(self):
    self.n = {"torch.sort": 0, "sorted_keys": 0}
    self._sort, self._keys = torch.sort, replay.sorted_keys

    def sort(*a, **k):
      self.n["torch.sort"] += 1
      return self._sort(*a, **k)

    def keys(*a, **k):
      self.n["sorted_keys"] += 1
      return self._keys(*a, **k)

    torch.sort, replay.sorted_keys = sort, keys
    return self

  def __exit__(self, *exc):
    torch.sort, replay.sorted_keys = self._sort, self._keys

  def require_none(self, path):
    if any(self.n.values()):
      raise AssertionError(f"the {path} path sorted: {self.n}")
    return f"{path}-path calls of torch.sort and sorted_keys: {self.n}"


def check_path(name, launches):
  missing = [k for k in PATHS[name] if launches[k] <= 0]
  if missing:
    raise AssertionError(f"kernels not launched on the {name} path: "
                         f"{missing}")


def steady(phase, tag, s):
  h = s.head
  ms = wall_ms(lambda: s.decode_window(0, h.sz, check_crcs=True), 5)
  mean = sum(ms) / len(ms)
  say(phase, f"steady {tag} decode_window(0, {h.sz}, check_crcs=True) ms: "
             + ", ".join(f"{m:.3f}" for m in ms)
             + f"; mean {mean:.3f} ms, "
               f"{h.sx * h.sy * h.sz / mean / 1e3:.1f} MVx/s")


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
  check_no_reference()

  with tempfile.TemporaryDirectory() as tmp:
    t_or = time.perf_counter()
    oracles, paths = start_oracle(tmp)
    try:
      return run(dev, card, kind, oracles, paths, t_or)
    finally:
      for proc in oracles:
        if proc.poll() is None:
          proc.kill()
          proc.wait()


def run(dev, card, kind, oracles, paths, t_or):
  t0 = time.perf_counter()
  _build.library()
  say(2, f"built kernels in {time.perf_counter() - t0:.3f} s "
         f"(nvcc {_build.build_seconds:.3f} s, one process per source)")

  b512, b256, bu64 = read(VOL512), read(VOL256), read(VOLU64)
  bmkv, bpins = read(VOLMKV), read(VOLPINS)
  errs = {name: 0.0 for name, *_ in KERNELS}
  t0 = time.perf_counter()
  sub = compare_kernels(b512, 32, dev, "512^3[:32]", errs)
  compare_kernels(bu64, 32, dev, "u64[:32]", errs)
  compare_kernels(bpins, 128, dev, "pins 256^2x128", errs)
  # tile seams: the kernels with a 64-codepoint tile against the plain
  # versions at the default tile, on the 256^2 volume
  _, _, _, want, sx, sy, perm, *_ = compare_kernels(
    b256, 128, dev, "256^2x128", errs)
  t = eng.params_from_jax(eng.prepare_slice_inputs(b256, 0, 128), None,
                          dev)
  # and the compact replay in windows of 64 positions
  replay.TILE, window, replay.COMPACT_WINDOW = 64, replay.COMPACT_WINDOW, 64
  try:
    ev, c, dr = replay.replay_keys(t["packed"], t["nbytes"], t["n_chains"])
    ids = replay.replay_positions(ev, c, dr, t["nodes"], sx, sy)
    dense = replay.cancel_sums(ev, c, dr)
    idc = replay.replay_positions_compact(c, replay.compact_closes(
      dense, replay.close_cap(ev.shape[1], t["nodes"].shape[1])),
      t["nodes"], sx, sy)
  finally:
    replay.TILE, replay.COMPACT_WINDOW = 1024, window
  require_equal("tile-64 vcg", replay.paint_vcg(ids, sx, sy, perm), want)
  errs["replay_positions_compact"] = max(
    errs["replay_positions_compact"],
    require_equal("64-position-window compact edge ids", idc, ids))
  # the depth tables in the scratch tensor for each slice whose depth
  # range passes a 1-entry shared table
  table, replay.DEPTH_TABLE = replay.DEPTH_TABLE, 1
  try:
    if int((dr[:, 1] - dr[:, 0]).max()) < 1:
      raise AssertionError("no slice's depth range passes 1 entry")
    ids4 = replay.replay_positions(ev, c, dr, t["nodes"], sx, sy)
    dense4 = replay.cancel_sums(ev, c, dr)
  finally:
    replay.DEPTH_TABLE = table
  errs["replay_positions"] = max(errs["replay_positions"], require_equal(
    "scratch-table edge ids", ids4, ids))
  errs["cancel_sums"] = max(errs["cancel_sums"], require_equal(
    "scratch-table dense close records", dense4, dense), require_equal(
    "dense close records", dense, replay.cancel_sums_plain(ev, c, dr)))
  # CCL tile seams: a 64-pixel tile on the 256^2 VCG; a snake through
  # every tile (N = 1) and a checkerboard, whose VCG links nothing
  # (N = n), at 512^2
  for tag, v, n_want in (
      ("256^2x128", want, None),
      ("512^2 snake", torch.from_numpy(snake_vcg(2, 512, 512)).to(dev), 1),
      ("512^2 checkerboard", torch.zeros((2, 512, 512), dtype=torch.int32,
                                         device=dev), 512 * 512)):
    e = compare_ccl_tiles(v, dev, tag, n_want)
    for name in ("ccl_paint", "ccl_min", "ccl_min_roots"):
      errs[name] = max(errs[name], e)
  say(3, f"kernels bit-equal to their plain versions on 512^3[:32], "
         f"256^2x128, u64[:32], pins 256^2x128, the replay at tile 64 and "
         f"with its depth table in the scratch tensor, "
         f"cancel_sums with its depth tables in the scratch tensor, "
         f"replay_positions_compact in windows of 64 positions, "
         f"the CCL at 64-pixel tiles and on a 512^2 snake and "
         f"checkerboard, "
         f"ccl_min -> roots_from_tgt -> plant equal to ccl_paint and "
         f"replay_positions_compact equal to replay_positions on each: "
         f"max_abs_err {errs} ({time.perf_counter() - t0:.1f} s)")

  for proc in oracles:
    if proc.wait(timeout=900) != 0:
      raise AssertionError(f"the host oracle failed ({proc.returncode})")
  t_or = time.perf_counter() - t_or
  say(3, f"host oracle done in {t_or:.1f} s (three child processes: five "
         "decodes, the 512^3 pins compress, label statistics, cutouts, "
         "the 1024^2 and long-slice volumes)")
  # phase 18's oracle needs the pins and long-slice streams just written;
  # it ends before anything is timed, as the first one does
  t_or = time.perf_counter()
  procs, ops_out = start_ops_oracle(paths)
  oracles.extend(procs)
  ops_oracle = finish_ops_oracle(procs, ops_out)
  say(3, f"operations oracle done in {time.perf_counter() - t_or:.1f} s "
         f"(four child processes: the host-loop VCGs, contacts, each, "
         f"array_equal, mode_pooling_2x2x1, connected_components)")

  # kernel, plain and library-call times at the 512^3 slice shapes
  # (first 32 slices), and each kernel's bound on the same inputs
  (t, cp, idsp, vp, sx, sy, perm, Lp, roots, ccp, cap_s, densep,
   tablesp, evp, drp) = sub
  Tt = t["T"]
  ccap = tablesp.shape[2]
  rcap = roots.shape[1]
  args = {
    "replay_keys": (lambda: replay.replay_keys(
      t["packed"], t["nbytes"], t["n_chains"]), lambda: replay.
      replay_keys_plain(t["packed"], t["nbytes"], t["n_chains"])),
    "replay_positions": (lambda: replay.replay_positions(
      evp, cp, drp, t["nodes"], sx, sy), lambda: replay.
      replay_positions_plain(evp, cp, drp, t["nodes"], sx, sy)),
    "paint_vcg": (lambda: replay.paint_vcg(idsp, sx, sy, perm),
                  lambda: replay.paint_vcg_plain(idsp, sx, sy, perm)),
    "ccl_paint": (lambda: ccl.ccl_paint(vp, Tt),
                  lambda: ccl.ccl_paint_plain(vp, Tt)),
    "ccl_min": (lambda: ccl.ccl_min(vp), lambda: ccl.ccl_min_plain(vp)),
    "ccl_min_roots": (lambda: ccl.ccl_min_roots(vp, rcap), lambda: ccl.
                      roots_from_tgt(ccl.ccl_min_plain(vp)[1], rcap)),
    "plant": (lambda: ccl.plant(Lp, roots, Tt),
              lambda: ccl.plant_plain(Lp, roots, Tt)),
    "slice_stats": (lambda: stats.slice_stats(ccp, sx, sy, cap_s),
                    lambda: stats.slice_stats_plain(ccp, sx, sy, cap_s)),
    "cancel_sums": (lambda: replay.cancel_sums(evp, cp, drp),
                    lambda: replay.cancel_sums_plain(evp, cp, drp)),
    "compact_closes": (lambda: replay.compact_closes(densep, ccap),
                       lambda: replay.compact_closes_plain(densep, ccap)),
    "replay_positions_compact": (lambda: replay.replay_positions_compact(
      cp, tablesp, t["nodes"], sx, sy),
      lambda: replay.replay_positions_compact_plain(
        cp, tablesp, t["nodes"], sx, sy)),
    "crc32c_rows": (lambda: crc32c.crc32c_rows(ccp),
                    lambda: crc32c.crc32c_rows_plain(ccp)),
  }
  # each kernel over 200 launches in one CUDA graph (the wrappers'
  # Python outlasts the shortest kernels), and over 10 eager launches
  # beside it
  times, eager = {}, {}
  for name, (kern, plain) in args.items():
    eager[name] = cuda_ms(kern, 10)
    times[name] = (graph_ms(kern, 200), cuda_ms(plain, 2))
  library = {name: None for name in args}
  # the one PyTorch call that computes compact_closes: a scatter of the
  # stacked records by rank into tables set empty (pos CAP, sums 0),
  # timed as the kernels are
  dest = densep[0].to(torch.int64)
  tgt = torch.where((dest >= 0) & (dest < ccap), dest, ccap).expand(
    3, *dest.shape).contiguous()
  empty = torch.zeros((3, dest.shape[0], ccap + 1), dtype=torch.int32,
                      device=dev)
  empty[0] = dest.shape[1]
  library["compact_closes"] = graph_ms(
    lambda: empty.scatter_(2, tgt, densep[1:]), 200)
  eager["scatter_"] = cuda_ms(lambda: empty.scatter_(2, tgt, densep[1:]),
                              10)
  bounds = {name: bound(name, *io) for name, io in kernel_io(
    t, cp, idsp, vp, Lp, roots, ccp, cap_s, densep, tablesp, evp,
    drp).items()}
  # paint_vcg and plant at B = 1 (the first slice: a CLI -T, a remote
  # read), checked against their plain versions, then timed as above
  one = b1_rows(idsp[:1].contiguous(), sx, sy, perm, Lp[:1].contiguous(),
                roots[:1].contiguous(), Tt[:1].contiguous(), errs)
  del sub, args, t, cp, idsp, vp, Lp, roots, ccp, densep, tablesp
  del evp, drp
  del dest, tgt, empty

  launches = {}
  # name -> (batch, ms, bound ms) at the batch its path runs
  full = {}
  # 4: the flat main path
  ct.reset_launches()
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  stream = ct.upload_stream(b512, dev)
  if stream is None:
    raise AssertionError("upload_stream declined the 512^3 volume")
  torch.cuda.synchronize()
  t_up = time.perf_counter() - t0
  t0 = time.perf_counter()
  with SortCount() as sorts:
    labels, cc, N = stream.decode_window(0, 512, check_crcs=True)
    torch.cuda.synchronize()
  t_dec = time.perf_counter() - t0
  launches["flat"] = dict(ct.LAUNCHES)
  head = stream.head
  sx, sy, sz = head.sx, head.sy, head.sz
  if labels.shape != (sz, sx * sy) or labels.dtype != torch.uint32:
    raise AssertionError(f"labels {tuple(labels.shape)} {labels.dtype}")
  want = np.load(paths["512"])
  require_labels("512^3", labels, want)
  say(4, f"512^3 u32 (CAP {stream.packed.shape[1] * 4}, "
         f"{stream.nbytes_device} bytes on the card): upload_stream "
         f"{t_up * 1e3:.3f} ms, first decode_window(0, 512, "
         f"check_crcs=True) {t_dec * 1e3:.3f} ms, labels bit-equal to the "
         f"host decoder, max N {int(N.max())}")
  crc_rows = crc_shape_rows(cc, stream.crcs, errs)
  for tag, (km, pm, bms, by, nb, nops) in crc_rows.items():
    say(4, f"crc32c_rows {tag} (the 512^3 ids): kernel {km:.4f} ms, plain "
           f"{pm:.4f} ms, bound {bms * 1e3:.2f} us by {by} ({nb} bytes, "
           f"{nops} ops; {100 * bms / km:.1f}% of the bound), equal to the "
           f"plain version" + (" and the stored words" if tag != "1024x64"
                               else ""))
  km, _, bms, *_ = crc_rows[f"{sz}x{sx * sy}"]
  full["crc32c_rows"] = (sz, km, bms)
  crc_b1 = crc_rows[f"1x{sx * sy}"]
  del labels, cc

  # 5: a window
  lw, _, _ = stream.decode_window(100, 164, check_crcs=True)
  require_labels("decode_window(100, 164)", lw, want[100:164])
  say(5, "decode_window(100, 164, check_crcs=True) bit-equal")
  del lw

  # 6: u64 labels (K = 2), the 256^2 class of the replay, markov order 5
  small = {}
  for tag, binary, ref, dtype in (
      ("u64 256^2x128", bu64, "u64", torch.uint64),
      ("u32 256^2x128", b256, "256", torch.uint32),
      ("markov-5 256^2x128", bmkv, "mkv", torch.uint32)):
    t0 = time.perf_counter()
    s = ct.upload_stream(binary, dev)
    if s is None:
      raise AssertionError(f"upload_stream declined the {tag} volume")
    torch.cuda.synchronize()
    t_up_s = time.perf_counter() - t0
    lab, _, _ = s.decode_window(0, s.head.sz, check_crcs=True)
    if lab.dtype != dtype:
      raise AssertionError(f"{tag}: labels {lab.dtype}, want {dtype}")
    require_labels(tag, lab, np.load(paths[ref]))
    small[tag] = s
    say(6, f"{tag} (CAP {s.packed.shape[1] * 4}): upload_stream "
           f"{t_up_s * 1e3:.3f} ms, labels bit-equal to the host decoder")

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
  say(8, f"flat-path launches {launches['flat']}")
  check_path("flat", launches["flat"])
  say(8, sorts.require_none("flat"))
  for tag, s in [("512^3", stream)] + list(small.items()):
    steady(8, tag, s)
  stages = stage_times(stream)
  say(8, "512^3 stage ms at B=512 (CUDA events): " + ", ".join(
    f"{k} {v:.3f}" for k, v in stages.items())
      + f"; sum {sum(stages.values()):.3f}")
  for tile in (ccl.TILE_PIX, 4096, 2048):
    for name, ms in ccl_pass_times(stream, tile).items():
      say(8, f"{name} passes at B=512, tile {tile} (torch.profiler, one "
             f"call): " + (", ".join(f"{k} {v:.3f}" for k, v in ms.items())
                           + f"; sum {sum(ms.values()):.3f} ms" if ms
                           else "not measured"))
  for name, (km, pm) in times.items():
    lib = library[name]
    nb, nops, bms, by = bounds[name]
    say(8, f"{name}: kernel {km:.4f} ms, plain {pm:.4f} ms, library call "
           + (f"{lib:.4f} ms" if lib is not None else "none")
           + f", bound {bms * 1e3:.2f} us by {by} ({nb} bytes, {nops} ops; "
             f"{100 * bms / km:.1f}% of the bound) (B=32 slices of 512^3; "
             f"200 launches in one CUDA graph; 10 eager launches "
             f"{eager[name]:.4f} ms)")
  for name, (km, pm, bms, by, nb, nops, ms10) in one.items():
    say(8, f"{name}: kernel {km:.4f} ms, plain {pm:.4f} ms, library call "
           f"none, bound {bms * 1e3:.2f} us by {by} ({nb} bytes, {nops} "
           f"ops; {100 * bms / km:.1f}% of the bound) (B=1, the first slice "
           f"of 512^3; 200 launches in one CUDA graph; 10 eager launches "
           f"{ms10:.4f} ms)")
  km, lib = times["compact_closes"][0], library["compact_closes"]
  say(8, f"compact_closes {km:.4f} ms against its library call (scatter_)"
         f" {lib:.4f} ms at B=32, 200 launches in one CUDA graph each "
         f"({'no slower' if km <= lib else 'SLOWER'}); 10 eager launches "
         f"{eager['compact_closes']:.4f} and {eager['scatter_']:.4f} ms")
  io512 = full_io(stream)
  say(8, path_batch_equal(stream, errs))
  for name in ("replay_keys", "replay_positions", "paint_vcg", "ccl_paint"):
    full[name] = (512, stages[name], bound(name, *io512[name])[2])
    say(8, "512^3 stage " + share_line(name, stages[name], io512[name], 512))
  say(8, replay_stage_line(stream, stages))
  say(8, busy_share(stream))

  # 9: the compact-cancel path on the same volume
  replay.CANCEL_COMPACT = True
  try:
    ct.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cs = ct.upload_stream(b512, dev)
    with SortCount() as sorts:
      labels, _, _ = cs.decode_window(0, 512, check_crcs=True)
      torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    launches["compact"] = dict(ct.LAUNCHES)
    require_labels("compact 512^3", labels, want)
    del labels
    say(9, f"compact-cancel path: upload_stream + first decode_window(0, "
           f"512, check_crcs=True) {t_dec * 1e3:.3f} ms, labels bit-equal "
           f"to the host decoder")
    say(9, f"compact-path launches {launches['compact']}")
    say(9, sorts.require_none("compact"))
    check_path("compact", launches["compact"])
    if launches["compact"]["replay_positions"]:
      raise AssertionError("the compact path launched replay_positions")
    steady(9, "compact 512^3", cs)
  finally:
    replay.CANCEL_COMPACT = False
  steady(9, "default 512^3 (after the compact path)", stream)
  ctimes = compact_stage_times(stream)
  path_ms = sum(ctimes[k] for k in PATHS["compact"] if k in ctimes)
  say(9, "512^3 compact stage ms at B=512 (CUDA events): " + ", ".join(
    f"{k} {v:.4f}" for k, v in ctimes.items())
      + f"; cancel_sums + compact_closes + replay_positions_compact "
        f"{path_ms:.4f} against replay_positions "
        f"{ctimes['replay_positions']:.4f}")
  for name in ("cancel_sums", "compact_closes", "replay_positions_compact"):
    full[name] = (512, ctimes[name], bound(name, *io512[name])[2])
    say(9, "512^3 stage " + share_line(name, ctimes[name], io512[name], 512)
           + (" (200 launches in one CUDA graph)"
              if name == "compact_closes" else ""))
  for name in ("cancel_sums", "replay_positions_compact"):
    km, bms = times[name][0], bounds[name][2]
    say(9, f"{name}: B=32 {km:.4f} ms against its bound "
           f"{bms * 1e3:.2f} us ({100 * bms / km:.1f}%); B=512 "
           f"{full[name][1]:.4f} ms against {full[name][2] * 1e3:.2f} us "
           f"({100 * full[name][2] / full[name][1]:.1f}%)")
  say(9, compact_design_line(stream))
  del cs
  del small

  # 10: the pins path
  bp512 = read(paths["pins512"])
  ct.reset_launches()
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  ps = ct.upload_stream(bp512, dev)
  if ps is None or ps.pins is None:
    raise AssertionError("upload_stream declined the 512^3 pins stream")
  torch.cuda.synchronize()
  t_up = time.perf_counter() - t0
  t0 = time.perf_counter()
  with SortCount() as sorts:
    labels, _, _ = ps.decode_window(0, 512, check_crcs=True)
    torch.cuda.synchronize()
  t_dec = time.perf_counter() - t0
  launches["pins"] = dict(ct.LAUNCHES)
  require_labels("pins 512^3", labels, want)
  del labels
  lw, _, _ = ps.decode_window(100, 164)
  require_labels("pins decode_window(100, 164)", lw, want[100:164])
  del lw
  say(10, f"512^3 pins ({len(bp512)} bytes, cap_n {ps.pins[5]}, "
         f"{ps.nbytes_device} bytes on the card): upload_stream "
         f"{t_up * 1e3:.3f} ms, first decode_window(0, 512, "
         f"check_crcs=True) {t_dec * 1e3:.3f} ms; it and "
         f"decode_window(100, 164) bit-equal to the volume")
  say(10, f"pins-path launches {launches['pins']}")
  check_path("pins", launches["pins"])
  say(10, sorts.require_none("pins"))
  p256 = ct.upload_stream(bpins, dev)
  lab, _, _ = p256.decode_window(0, p256.head.sz, check_crcs=True)
  require_labels("pins 256^2x128", lab, np.load(paths["pins256"]))
  lw, _, _ = p256.decode_window(40, 90, check_crcs=True)
  require_labels("pins 256^2x128 [40, 90)", lw,
                 np.load(paths["pins256"])[40:90])
  say(10, "pins 256^2x128: decode_window(0, 128) and (40, 90) bit-equal "
         "to the host decoder")
  steady(10, "pins 512^3", ps)
  steady(10, "pins 256^2x128", p256)
  ptimes = pins_stage_times(ps)
  say(10, "pins 512^3 stage ms at B=512 (CUDA events): " + ", ".join(
    f"{k} {v:.3f}" for k, v in ptimes.items() if not k.startswith("v"))
      + f"; CCL and paint as ccl_min_roots + plant x2 "
        f"{ptimes['v2']:.3f} ms, as ccl_paint K=0 + ccl_paint K=1 "
        f"{ptimes['v1']:.3f} ms")
  # bounds from the flat stream's tensors of the same volume (plant: its
  # K = 1 table and roots, which differ from the pins ones only in the
  # roots' few kilobytes)
  for name, stage in (("ccl_min", "ccl_min"),
                      ("ccl_min_roots", "ccl_min_roots"),
                      ("plant", "plant K=1")):
    full[name] = (512, ptimes[stage], bound(name, *io512[name])[2])
    say(10, "pins 512^3 stage " + share_line(name, ptimes[stage],
                                             io512[name], 512))
  del ps, p256, want

  # 11: analytics of the flat 512^3 stream
  orc = np.load(paths["stats"])
  ct.reset_launches()
  wall = {}
  t0 = time.perf_counter()
  vc = ct.voxel_counts(b512, device=dev)
  wall["voxel_counts"] = time.perf_counter() - t0
  t0 = time.perf_counter()
  cen = ct.centroids(b512, device=dev)
  wall["centroids"] = time.perf_counter() - t0
  t0 = time.perf_counter()
  bb = ct.bounding_boxes(b512, no_slice_conversion=True, device=dev)
  wall["bounding_boxes"] = time.perf_counter() - t0
  launches["analytics"] = dict(ct.LAUNCHES)
  check_analytics(orc, vc, cen, bb)
  say(11, f"512^3 analytics of {len(orc['uniq'])} labels: voxel_counts "
          f"and bounding_boxes equal to the numpy oracle, centroids within "
          f"rtol 1e-12; wall s " + ", ".join(
            f"{k} {v:.3f}" for k, v in wall.items()))
  say(11, f"analytics-path launches {launches['analytics']}")
  check_path("analytics", launches["analytics"])
  cc_w, _, _ = ct.decode_window_ccl_device(b512, 0, 256, dev)
  _, cum, _ = eng._flat_label_tables(head, b512)
  cap_w = eng._next_pow2(max(int((cum[1:] - cum[:-1]).max()), 8))
  ms_w = cuda_ms(lambda: stats.slice_stats(cc_w, 512, 512, cap_w), 20)
  io_w = slice_stats_io(cc_w, cap_w)
  full["slice_stats"] = (256, ms_w, bound("slice_stats", *io_w)[2])
  say(11, f"per 256-slice window of 512^3 (cap_n {cap_w}; CUDA events, "
          f"mean of 20): " + share_line("slice_stats", ms_w, io_w, 256))
  parts = device_ms_by_kernel(
    lambda: stats.slice_stats(cc_w, 512, 512, cap_w),
    DEVICE_KERNELS["slice_stats"])
  say(11, "slice_stats passes per window (torch.profiler, one call): "
          + (", ".join(f"{k} {v:.4f} ms" for k, v in parts.items())
             if parts else "not measured"))
  default = stats.BAND_PX
  for band_px in (8192, 32768, default):
    stats.BAND_PX = band_px
    try:
      ms = cuda_ms(lambda: stats.slice_stats(cc_w, 512, 512, cap_w), 20)
    finally:
      stats.BAND_PX = default
    say(11, f"slice_stats per window at BAND_PX {band_px} "
            f"({max(1, band_px // 512)} rows a band): {ms:.4f} ms")
  del cc_w

  # 12: CrackleDeviceArray cutouts
  arrays = {"512^3": ct.CrackleDeviceArray(b512, dev),
            "u64": ct.CrackleDeviceArray(bu64, dev),
            "pins 512^3": ct.CrackleDeviceArray(bp512, dev)}
  for (tag, _, key), path in zip(CUTOUTS, paths["cutouts"]):
    got = arrays[tag][eval(f"np.s_[{key}]")]
    if got.device.type != "cuda":
      raise AssertionError(f"{tag}[{key}] not on the card")
    require_labels(f"{tag}[{key}]", got, np.load(path))
  for tag, arr in arrays.items():
    arr.check_crcs()
  say(12, "CrackleDeviceArray cutouts equal those of the decoded volumes "
          "(the pins one that of the flat stream of the same volume): "
          + "; ".join(
    f"{tag}[{key}]" for tag, _, key in CUTOUTS)
      + "; check_crcs() passed on each array")

  # 13: slices past one block's shared memory
  phase_1024(dev, paths["1024"], errs)

  # 14: the window-decode entry points and codec.decompress on the card
  launches["windows"] = phase_windows(dev, paths, [
    ("512^3", b512, paths["512"]), ("u64 256^2x128", bu64, paths["u64"]),
    ("u32 256^2x128", b256, paths["256"]),
    ("markov-5 256^2x128", bmkv, paths["mkv"]),
    ("pins 256^2x128", bpins, paths["pins256"]),
    ("pins 512^3", bp512, paths["512"])])

  # 15: the long-slice volume through the split and the gather paint
  launches["long"] = phase_long(dev, paths["long"], errs)

  # 16: the device encode of the labels the flat 512^3 decode left on the
  # card, of the u64 volume and of the long-slice volume
  launches["encode"], k0 = phase_encode(dev, stream, bu64, paths)

  # 17: the z-sharded codec on meshes of the card, through a one-rank
  # NCCL group and in two processes on the card
  sharded = phase_sharded(dev, stream, paths)

  # 18: the stream operations and analytics on the card
  launches["operations"] = phase_operations(dev, ops_oracle, paths)

  # 19: the host arrays, util, the CLI and profiling on the card
  launches["arrays"] = phase_arrays(dev, stream, paths, ops_oracle, card)

  check_no_reference()
  out = []
  for name, src, repl, also, path in KERNELS:
    row = {"name": name, "route": "cuda", "source": src, "replaces": repl,
           "launches": launches[path][name] if path else 0,
           "launch_path": path or None,
           "max_abs_err": errs[name], "ms": times[name][0],
           "plain_ms": times[name][1], "bound_ms": bounds[name][2],
           "bound_by": bounds[name][3], "library_ms": library[name],
           "timed_batch": 32, "path_batch": full[name][0],
           "path_batch_ms": full[name][1],
           "path_batch_bound_ms": full[name][2]}
    if also:
      row["also_replaces"] = also
    if name == "ccl_paint":
      row.update(k0)
    if name in one:
      km, pm, bms, *_ = one[name]
      row.update({"b1_ms": km, "b1_plain_ms": pm, "b1_bound_ms": bms})
    if name == "crc32c_rows":
      km, pm, bms, *_ = crc_b1
      row.update({"b1_ms": km, "b1_plain_ms": pm, "b1_bound_ms": bms})
      row["shapes"] = {tag: {"ms": km, "plain_ms": pm, "bound_ms": bms}
                       for tag, (km, pm, bms, *_) in crc_rows.items()}
    row["sharded_launches"] = {path: n[name] for path, n in sharded.items()
                               if n.get(name)}
    row["operations_launches"] = launches["operations"][name]
    row["arrays_launches"] = launches["arrays"][name]
    out.append(row)
  print(card)
  print(json.dumps({"kernels": out}))
  print(json.dumps({"ok": True, "device": {
    "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
  return 0


def phase_1024(dev, paths, errs):
  """The 1024^2 x 8 flat and pins streams, decoded with the CRC gate
  against the host oracle (the paint in bands), the paint kernel
  against its plain version on their edge ids, and the flat stream's
  analytics against the numpy statistics."""
  flat, pins, npy, npz = paths
  want = np.load(npy)
  bands, P = replay.paint_grid(8, 1024, 1024, _build.sm_count(dev))
  for tag, binary in (("flat", read(flat)), ("pins", read(pins))):
    s = ct.upload_stream(binary, dev)
    if s is None:
      raise AssertionError(f"upload_stream declined the 1024^2 {tag} stream")
    ct.reset_launches()
    labels, _, _ = s.decode_window(0, 8, check_crcs=True)
    torch.cuda.synchronize()
    require_labels(f"1024^2 {tag}", labels, want)
    if not ct.LAUNCHES["paint_vcg"]:
      raise AssertionError("paint_vcg not launched on the 1024^2 decode")
    h = s.head
    ev, cls, dr = replay.replay_keys(s.packed, s.nbytes, s.n_chains)
    ids = replay.replay_positions(ev, cls, dr, s.nodes, h.sx, h.sy)
    errs["paint_vcg"] = max(errs["paint_vcg"], require_equal(
      f"1024^2 {tag} vcg", replay.paint_vcg(ids, h.sx, h.sy, s.permissible),
      replay.paint_vcg_plain(ids, h.sx, h.sy, s.permissible)))
    say(13, f"1024^2 x 8 {tag} ({len(binary)} bytes, CAP "
            f"{s.packed.shape[1] * 4}): decode_window(0, 8, check_crcs=True) "
            f"bit-equal to the host decoder, the paint in "
            f"{bands} bands of {P} pixels a slice bit-equal to its "
            f"plain version; launches {dict(ct.LAUNCHES)}")
  orc = np.load(npz)
  ct.reset_launches()
  vc = ct.voxel_counts(read(flat), device=dev)
  cen = ct.centroids(read(flat), device=dev)
  bb = ct.bounding_boxes(read(flat), no_slice_conversion=True, device=dev)
  if ct.LAUNCHES["slice_stats"] != 3:
    raise AssertionError(f"1024^2 analytics launches {dict(ct.LAUNCHES)}")
  check_analytics(orc, vc, cen, bb)
  say(13, f"1024^2 x 8 analytics of {len(orc['uniq'])} labels on the card "
          f"(slice_stats launched 3 times): voxel_counts and bounding_boxes "
          f"equal to the numpy oracle, centroids within rtol 1e-12")


class HostDeclines(logging.Handler):
  """Records every decline the engine logs (engine._fallback), and every
  analytics route that falls back to its host loop, while it is
  entered. require_none fails on any decline but decode_window_device's
  of a long window, where the caller takes the split on the card (the
  reference's own route, engine.py:700-712)."""

  LOGGERS = (eng.logger, analytics.logger)

  def __enter__(self):
    logging.Handler.__init__(self, logging.WARNING)
    self.seen = []
    for log in self.LOGGERS:
      log.addHandler(self)
    return self

  def emit(self, record):
    self.seen.append(record.getMessage())

  def __exit__(self, *exc):
    for log in self.LOGGERS:
      log.removeHandler(self)

  def require_none(self, path):
    host = [m for m in self.seen if not m.startswith("decode_window_device:")]
    if host:
      raise AssertionError(f"the {path} path ended on the host codec: {host}")
    return (f"{path}: no call ended on the host codec "
            f"({len(self.seen)} decode_window_device declines)")


def window_labels(binary):
  """Two labels of the stream (its first and last) and one absent."""
  uniq = pcodec.labels(binary)
  return [int(uniq[0]), int(uniq[-1]), int(uniq.max()) + 1]


def phase_windows(dev, paths, streams):
  """decode_window of each stream, whole, on [3, 7) and on its last slice,
  label= masks on the flat streams, and codec.decompress under
  set_engine('torch'), against the oracle's volumes (sz, sy*sx); every
  call must stay on the card. Returns the launch counts."""
  ct.reset_launches()
  with HostDeclines() as declines:
    for tag, binary, npy in streams:
      want = np.load(npy, mmap_mode="r")
      head = pcodec.header(binary)
      sz = head.sz
      ms = []
      for z0, z1 in ((0, sz), (3, 7), (sz - 1, sz)):
        t0 = time.perf_counter()
        got = ct.decode_window(binary, z0, z1, device=dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        if got is None:
          raise AssertionError(f"{tag} decode_window({z0}, {z1}) declined")
        require_volume(f"{tag} decode_window({z0}, {z1})", got, want[z0:z1],
                       head)
      masks = []
      if head.label_format == 0:
        for label in window_labels(binary):
          got = ct.decode_window(binary, 0, sz, label=label, device=dev)
          require_volume(f"{tag} label={label}", got, want == label, head)
          masks.append(f"{label} ({int(got.sum())} voxels)")
      pcodec.set_engine("torch", device=dev)
      try:
        t0 = time.perf_counter()
        got = pcodec.decompress(binary)
        t_codec = (time.perf_counter() - t0) * 1e3
        require_volume(f"{tag} decompress under torch", got, want, head)
        if masks:
          label = window_labels(binary)[0]
          require_volume(f"{tag} decompress(label={label}) under torch",
                         pcodec.decompress(binary, label=label),
                         want == label, head)
      finally:
        pcodec.set_engine("auto")
      say(14, f"{tag}: decode_window whole, [3, 7) and [{sz - 1}, {sz}) "
              f"equal to the oracle (first calls {', '.join(f'{m:.3f}' for m in ms)} ms); "
              + (f"label= masks of {', '.join(masks)} equal; " if masks else
                 "label= queries of pins streams stay on the host as in the "
                 "reference (engine.py:671-672), not run; ")
              + f"codec.decompress under set_engine('torch') equal "
                f"({t_codec:.3f} ms)")
  say(14, declines.require_none("window-decode"))
  launched = dict(ct.LAUNCHES)
  say(14, f"window-decode launches {launched}")
  missing = sorted({k for k in PATHS["pins"] + PATHS["flat"]
                    if launched[k] <= 0})
  if missing:
    raise AssertionError(f"kernels not launched by the window decodes: "
                         f"{missing}")
  return launched


def require_volume(what, got, want, head):
  """got: decode_window's (sx, sy, B) volume; want: (B, sy*sx) rows."""
  if got.dtype != want.dtype:
    raise AssertionError(f"{what}: dtype {got.dtype}, want {want.dtype}")
  if got.flags.f_contiguous != bool(head.fortran_order) and got.ndim == 3 \
     and min(got.shape) > 1:
    raise AssertionError(f"{what}: not in the header's memory order")
  rows = got.transpose(2, 1, 0).reshape(got.shape[2], -1)
  if not np.array_equal(rows, want):
    bad = np.flatnonzero((rows != want).any(axis=1))
    raise AssertionError(f"{what}: differs on {len(bad)} slices, first "
                         f"{bad[0]}")


def phase_long(dev, paths, errs):
  """The long-slice volume: its sizes against the device limits, the
  kernels against their plain versions at its shapes (its first four
  slices' pieces), decode_window(check_crcs=True) and
  decode_window_ccl_device against the oracle and the stored CRCs, the
  launches, throughput beside the oracle's host decode, stage times and
  the device memory high-water mark. Returns the launch counts."""
  ckl, npy, js = paths
  binary = read(ckl)
  with open(js) as f:
    secs = json.load(f)
  head = pcodec.header(binary)
  sx, sy, sz = head.sx, head.sy, head.sz
  inputs = eng.prepare_slice_inputs(binary, 0, sz)
  cps = inputs["nbytes"].astype(np.int64) * 4 - 3
  uniq, cum, keys = eng._flat_label_tables(head, binary)
  n_per = cum[1:] - cum[:-1]
  t0 = time.perf_counter()
  split, piece_z = eng.prepare_split_inputs(binary, 0, sz)
  t_split = time.perf_counter() - t0
  P = len(piece_z)
  if cps.min() <= eng.MAX_DEVICE_CAP or n_per.min() <= ccl.PAINT_CAP_N \
     or P <= sz:
    raise AssertionError(f"long-slice volume: codepoints {cps.min()}, "
                         f"components {n_per.min()}, pieces {P}")
  say(15, f"long-slice volume {sx}x{sy}x{sz} ({len(binary)} bytes; oracle: "
          f"made {secs['make']:.3f} s, compressed {secs['compress']:.3f} s, "
          f"host decode {secs['host_decode']:.3f} s = "
          f"{sx * sy * sz / secs['host_decode'] / 1e6:.1f} MVx/s): "
          f"{cps.min()}-{cps.max()} codepoints a slice (MAX_DEVICE_CAP "
          f"{eng.MAX_DEVICE_CAP}), {n_per.min()}-{n_per.max()} components a "
          f"slice (PAINT_CAP_N {ccl.PAINT_CAP_N}), {P} pieces of at most "
          f"{split['packed'].shape[1] * 4} codepoints "
          f"(prepare_split_inputs {t_split:.3f} s)")

  # the kernels against their plain versions on the first four slices'
  # pieces: the pieces' shapes, the merged rows and the 2048^2 slices
  k = int(np.searchsorted(piece_z, 4))
  sub = {key: split[key][:k] for key in ("packed", "nbytes", "nodes",
                                         "n_chains")}
  t = eng.params_from_jax(sub, device=dev, piece_z=piece_z[:k])
  perm = head.crack_format == ct.CrackFormat.PERMISSIBLE
  ev, cls, dr = replay.replay_keys(t["packed"], t["nbytes"], t["n_chains"])
  evp, clsp, drp = replay.replay_keys_plain(t["packed"], t["nbytes"],
                                            t["n_chains"])
  errs["replay_keys"] = max(errs["replay_keys"],
                            require_equal("long event words", ev, evp),
                            require_equal("long cls", cls, clsp),
                            require_equal("long depth ranges", dr, drp))
  ids = replay.replay_positions(evp, clsp, drp, t["nodes"], sx, sy)
  errs["replay_positions"] = max(errs["replay_positions"], require_equal(
    "long edge ids", ids, replay.replay_positions_plain(
      evp, clsp, drp, t["nodes"], sx, sy)))
  rows = dec.slice_rows(ids, t["piece_z"], 4)
  v = replay.paint_vcg(rows, sx, sy, perm)
  errs["paint_vcg"] = max(errs["paint_vcg"], require_equal(
    "long vcg", v, replay.paint_vcg_plain(rows, sx, sy, perm)))
  cc, N, _ = ccl.ccl_paint(v)
  ccp, Np, _ = ccl.ccl_paint_plain(v)
  errs["ccl_paint"] = max(errs["ccl_paint"],
                          require_equal("long cc", cc, ccp),
                          require_equal("long N", N, Np))
  stored = eng._stored_crcs(head, binary, dev)
  eng.crc_gate(cc, stored[:4], 0)
  say(15, f"kernels bit-equal to their plain versions on the first 4 "
          f"slices: {k} pieces ({tuple(t['packed'].shape)} packed bytes), "
          f"merged rows {tuple(rows.shape)}, paint_vcg in "
          f"{replay.paint_grid(4, sx, sy, _build.sm_count(dev))[0]} bands a "
          f"slice, ccl_paint "
          f"on (4, {sy}, {sx}); cc passes the stored CRCs")
  del t, ev, cls, dr, evp, clsp, drp, ids, rows, v, cc, N, ccp, Np

  want = np.load(npy)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  base = torch.cuda.memory_allocated()
  ct.reset_launches()
  with HostDeclines() as declines:
    t0 = time.perf_counter()
    vol = ct.decode_window(binary, 0, sz, check_crcs=True, device=dev)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    launched = dict(ct.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() - base
    if vol is None:
      raise AssertionError("decode_window declined the long-slice volume")
    require_volume("long decode_window(0, 32)", vol, want, head)
    del vol
    res = ct.decode_window_ccl_device(binary, 0, sz, dev)
    if res is None:
      raise AssertionError("decode_window_ccl_device declined the long-slice "
                           "volume")
    cc, N, _ = res
    eng.crc_gate(cc, stored, 0)
    if N.cpu().numpy().tolist() != n_per.tolist():
      raise AssertionError("decode_window_ccl_device: N differs from the "
                           "stream's component counts")
    w = ct.decode_window(binary, 5, 9, device=dev)
    require_volume("long decode_window(5, 9)", w, want[5:9], head)
    label = int(want[7, sx * sy // 2 + sx // 2]) or int(uniq[1])
    m = ct.decode_window(binary, 0, sz, label=label, device=dev)
    require_volume(f"long label={label}", m, want == label, head)
    del w, m
  say(15, declines.require_none("long-slice"))
  say(15, f"decode_window(0, {sz}, check_crcs=True) through "
          f"decode_window_ccl_device's split ({P} pieces) and the gather "
          f"paint equal to the oracle, first call {t_first:.3f} s; "
          f"decode_window_ccl_device's cc passes the stored CRCs and its N "
          f"equals the stream's counts; decode_window(5, 9) and the mask of "
          f"label {label} equal; launches {launched}; device memory "
          f"high-water mark {peak} bytes ({peak / 2 ** 30:.3f} GiB) above "
          f"{base} bytes held before")
  missing = [k for k in ("replay_keys", "replay_positions", "paint_vcg",
                         "ccl_paint") if launched[k] <= 0]
  if missing:
    raise AssertionError(f"kernels not launched on the long path: {missing}")
  ms = wall_ms(lambda: ct.decode_window(binary, 0, sz, check_crcs=True,
                                         device=dev), 3)
  mean = sum(ms) / len(ms)
  say(15, f"steady long-slice decode_window(0, {sz}, check_crcs=True) ms: "
          + ", ".join(f"{x:.3f}" for x in ms)
          + f"; mean {mean:.3f} ms, {sx * sy * sz / mean / 1e3:.1f} MVx/s "
            f"(host oracle's decode {secs['host_decode'] * 1e3:.3f} ms, "
            f"{sx * sy * sz / secs['host_decode'] / 1e6:.1f} MVx/s)")
  say(15, long_stage_line(binary, head, split, piece_z, cc, uniq, cum, keys,
                          dev))
  return launched


def require_bytes(what, got, want):
  if got != want:
    at = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
              min(len(got), len(want)))
    raise AssertionError(f"{what}: {len(got)} bytes, want {len(want)}; "
                         f"first difference at byte {at}")


def host_compress(rows, shape):
  """(seconds of each of two runs, bytes) of the port's host compress of
  the (sz, sy*sx) rows as the F-order (sx, sy, sz) volume they are."""
  sx, sy, sz = shape
  vol = rows.reshape(sz, sy, sx).transpose(2, 1, 0)
  pcodec.set_engine("numpy")
  try:
    secs = []
    for _ in range(2):
      t0 = time.perf_counter()
      out = pcodec.compress(vol)
      secs.append(time.perf_counter() - t0)
  finally:
    pcodec.set_engine("auto")
  return secs, out


def ccl_paint_k0_io(vcg):
  """(bytes, elements) of ccl_paint with no table: the VCG read once, cc
  and N written once."""
  return nbytes_of(vcg) + vcg.numel() * 4 + vcg.shape[0] * 4, vcg.numel()


def encode_stage_line(tag, vol):
  """Host-clock ms of each encode stage alone on vol (sx, sy, sz) on the
  card, 3 runs each after a warm one: stage 1 (batches of
  enc.STAGE1_PIX pixels, tables to the host), the host tail
  (assemble_flat_stream from the packed VCG on the card: fetch, trace
  and byte assembly), the fetch of the packed VCG alone (pinned chunks
  on a side stream, to the last event), the trace of the host rows on
  the thread pool alone; and the device ms (CUDA events, mean of 3) of
  stage 1's parts on its first batch."""
  sx, sy, sz = vol.shape
  zyx = vol.permute(2, 1, 0)
  st1 = wall_ms(lambda: enc._stage1_volume(zyx), 3)
  packed, tables, N, crcs, pairs = enc._stage1_volume(zyx)
  tail = wall_ms(lambda: enc.assemble_flat_stream(
    packed, tables, N, crcs, pairs, sx, sy, sz, data_width=vol.element_size(),
    fortran_order=True), 3)

  def fetch():
    _, chunks = enc._fetch(packed)
    for *_, ev in chunks:
      ev.synchronize()

  fe = wall_ms(fetch, 3)
  host = packed.cpu()
  perm = pairs < sx * sy * sz // 2
  tr = wall_ms(lambda: enc._trace(host, sx, sy, perm), 3)
  threads = pcodec._pool_size(0, sz)
  step = enc._batch_slices(sz, sx * sy)
  planes = zyx[:step]
  vcg = enc.labels_to_vcg(planes)
  cc, N = enc.ccl_from_labels(planes)
  parts = {
    "labels_to_vcg": cuda_ms(lambda: enc.labels_to_vcg(planes), 3),
    "ccl_paint K=0": cuda_ms(lambda: ccl.ccl_paint(vcg), 3),
    "crc32c": cuda_ms(lambda: crc32c.crc32c_rows(cc), 3),
    "component_labels": cuda_ms(lambda: enc.component_labels(planes, cc, N),
                                3),
    "pack": cuda_ms(lambda: enc._pack_vcg_nibbles(vcg), 3),
  }
  mean = np.mean
  return (f"{tag} encode stages alone (host clock, 3 runs): stage 1 "
          + ", ".join(f"{m:.3f}" for m in st1) + f" (mean {mean(st1):.3f})"
          + f" ms in {-(-sz // step)} batches of {step} slices; host tail "
          + ", ".join(f"{m:.3f}" for m in tail) + f" (mean {mean(tail):.3f})"
          + f" ms; fetch of "
            f"{packed.numel()} packed bytes " + ", ".join(
              f"{m:.3f}" for m in fe) + f" (mean {mean(fe):.3f}) ms; trace "
          + ", ".join(f"{m:.3f}" for m in tr) + f" (mean {mean(tr):.3f}) ms on {threads} threads"
          + f"; stage 1's first batch (B={step}) on the card, ms (CUDA "
            f"events, mean of 3): " + ", ".join(
              f"{k} {v:.3f}" for k, v in parts.items())), mean(st1)


def card_compress(tag, vol):
  """codec.compress of labels on the card, which must take the device
  encode: no decline logged and ccl_paint launched."""
  before = ct.LAUNCHES["ccl_paint"]
  with HostDeclines() as declines:
    out = pcodec.compress(vol)
  declines.require_none(f"{tag} encode")
  if ct.LAUNCHES["ccl_paint"] == before:
    raise AssertionError(f"the {tag} encode launched no ccl_paint")
  return out


def phase_encode(dev, stream, bu64, paths):
  """compress of labels on the card (the device encode): the flat 512^3
  stream's decode_window(0, 512) labels, reshaped and permuted, must
  give the committed stream's bytes, the u64 volume's likewise, and the
  long-slice volume the oracle's host compress; launches of the 512^3
  encode (reset just before), its memory high-water, steady times beside
  the port's host compress of the same labels, stage times, and
  ccl_paint with no table at B = 512 and at the encode's batch against
  its bound. Returns (the launch counts, ccl_paint's row keys)."""
  sx, sy, sz = stream.head.sx, stream.head.sy, stream.head.sz
  labels, _, _ = stream.decode_window(0, sz)
  vol = labels.reshape(sz, sy, sx).permute(2, 1, 0)
  if vol.permute(2, 1, 0).data_ptr() != labels.data_ptr() or \
     not vol.permute(2, 1, 0).is_contiguous():
    raise AssertionError("the (z, y, x) view of the decoded labels is a copy")
  b512 = read(VOL512)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  base = torch.cuda.memory_allocated()
  ct.reset_launches()
  t0 = time.perf_counter()
  got = card_compress("512^3", vol)
  t_first = time.perf_counter() - t0
  launched = dict(ct.LAUNCHES)
  peak = torch.cuda.max_memory_allocated() - base
  require_bytes("compress of the 512^3 labels on the card", got, b512)
  say(16, f"compress of the 512^3 labels that decode_window(0, {sz}) left "
          f"on the card (a (z, y, x) view of them, no copy) gives the "
          f"committed stream's {len(b512)} bytes; first call "
          f"{t_first * 1e3:.3f} ms; device memory high-water "
          f"{peak} bytes ({peak / 2 ** 30:.3f} GiB, "
          f"{peak / labels.numel() / 4:.2f} times the labels' bytes) above "
          f"{base} bytes held before")
  say(16, f"encode-path launches {launched}")
  check_path("encode", launched)

  vols = {"512^3": (vol, paths["512"], b512)}
  s64 = ct.upload_stream(bu64, dev)
  lab64, _, _ = s64.decode_window(0, s64.head.sz)
  h = s64.head
  vols["u64 256^2x128"] = (lab64.reshape(h.sz, h.sy, h.sx).permute(2, 1, 0),
                           paths["u64"], bu64)
  ckl, npy, js = paths["long"]
  long_rows = np.load(npy)
  with open(js) as f:
    secs = json.load(f)
  lx, ly, lz = SHAPE_LONG
  lt = torch.from_numpy(long_rows.view(np.int32)).to(dev).view(torch.uint32)
  vols["long 2048^2x32"] = (lt.reshape(lz, ly, lx).permute(2, 1, 0), npy,
                            read(ckl))
  del long_rows
  stage1 = {}
  for tag, (v, rows_path, want) in vols.items():
    if tag != "512^3":
      torch.cuda.synchronize()
      torch.cuda.reset_peak_memory_stats()
      base = torch.cuda.memory_allocated()
      require_bytes(f"compress of the {tag} labels on the card",
                    card_compress(tag, v), want)
      peak = torch.cuda.max_memory_allocated() - base
      say(16, f"compress of the {tag} labels on the card gives the "
              + ("committed stream's" if tag.startswith("u64") else
                 "oracle child's host compress's") + f" {len(want)} bytes; "
              f"device memory high-water {peak} bytes ({peak / 2 ** 30:.3f} "
              f"GiB, {peak / v.numel() / v.element_size():.2f} times the "
              f"labels' bytes)")
    n = v.numel()
    ms = wall_ms(lambda: require_bytes(
      f"steady compress of the {tag} labels on the card",
      card_compress(tag, v), want), 3)
    rows = np.load(rows_path, mmap_mode="r")
    hs, hout = host_compress(np.asarray(rows), tuple(v.shape))
    require_bytes(f"the host compress of the {tag} labels", hout, want)
    mean = sum(ms) / len(ms)
    line, stage1[tag] = encode_stage_line(tag, v)
    say(16, f"steady {tag} compress on the card (host clock) ms: "
            + ", ".join(f"{m:.3f}" for m in ms) + f"; mean {mean:.3f} ms, "
            f"{n / mean / 1e3:.1f} MVx/s; the port's host compress of the "
            f"same labels (numpy engine, this process) s: "
            + ", ".join(f"{x:.3f}" for x in hs)
            + f", {n / min(hs) / 1e6:.1f} MVx/s at best"
            + (f"; the oracle child's compress {secs['compress']:.3f} s"
               if tag.startswith("long") else ""))
    say(16, line + f"; stage 1 {100 * stage1[tag] / mean:.1f}% of the "
                   f"steady encode")
  del vols, lab64, s64, lt

  # ccl_paint with no table on the encode's VCG of 512^3: at B = 512 and
  # at the batch the encode runs
  zyx = vol.permute(2, 1, 0)
  step = enc._batch_slices(sz, sx * sy)
  k0 = {}
  for B in (sz, step):
    vcg = enc.labels_to_vcg(zyx[:B])
    ms = cuda_ms(lambda: ccl.ccl_paint(vcg), 3)
    io = ccl_paint_k0_io(vcg)
    say(16, "512^3 encode VCG " + share_line("ccl_paint", ms, io, B)
            + " (K = 0, CUDA events, mean of 3)")
    if B == step:
      k0 = {"encode_launches": launched["ccl_paint"],
            "encode_path_batch": B, "encode_path_batch_ms": ms,
            "encode_path_batch_bound_ms": bound("ccl_paint", *io)[2]}
    del vcg
  return launched, k0


# the kernels each shard of a sharded decode launches, by label format
SHARD_LAUNCHES = {
  "flat": {"replay_keys": 1, "replay_positions": 1, "paint_vcg": 1,
           "ccl_paint": 1},
  "pins": {"replay_keys": 1, "replay_positions": 1, "paint_vcg": 1,
           "ccl_min_roots": 1, "plant": 2},
}

# seconds a rank of phase 17(c) may take
RANK_TIMEOUT = 300


def free_port():
  with socket.socket() as s:
    s.bind(("localhost", 0))
    return s.getsockname()[1]


def launched_now():
  return {k: v for k, v in ct.LAUNCHES.items() if v}


def require_launches(what, want):
  got = launched_now()
  if got != want:
    raise AssertionError(f"{what}: launches {got}, want {want}")
  return got


def per_shard(mesh, kind):
  """The launches of a sharded decode over every shard of mesh."""
  n = len(mesh.devices)
  return {k: n * v for k, v in SHARD_LAUNCHES[kind].items()}


def encode_launches(mesh, sz, sxy):
  """ccl_paint and crc32c_rows launches of compress_sharded: one each a
  stage-1 batch of each shard."""
  n = sum(-(-(z1 - z0) // enc._batch_slices(z1 - z0, sxy))
          for _, z0, z1 in sharding._shards(mesh, sz))
  return {"ccl_paint": n, "crc32c_rows": n}


def require_counts(what, counts, orc):
  """counts (keys,) int64 of sharded_roundtrip_step: the oracle's voxel
  count of each label, then zeros."""
  n = len(orc["uniq"])
  got = counts.cpu().numpy()
  if not np.array_equal(got[:n], orc["count"]) or got[n:].any():
    raise AssertionError(f"{what}: counts differ from the oracle's")


def device_events(fn):
  """{kind: count} of the device events of one fn() call
  (torch.profiler): NCCL kernels, memory copies and other kernels."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    fn()
    torch.cuda.synchronize()
  kinds = {"nccl": 0, "memcpy": 0, "other": 0}
  for e in prof.events():
    if e.device_type == DeviceType.CUDA:
      name = e.name.lower()
      kinds["nccl" if "nccl" in name else "memcpy" if "memcpy" in name
            else "other"] += 1
  return kinds


def phase_sharded(dev, stream, paths):
  """The z-sharded codec (crackle_tpu_torch.parallel): (a) on a mesh of
  every card and on 4 shards of the first, decompress_sharded of the
  flat and pins 512^3, u64 and markov-5 streams (and of the 256^2 x 128
  u32 stream on 3 shards: 128 % 3 != 0) against the oracle,
  voxel_counts_sharded of 512^3 against its numpy counts,
  compress_sharded of the 512^3 and u64 labels on the card against the
  committed bytes, and sharded_roundtrip_step of 512^3 (counts against
  the oracle, z_index the slices' byte lengths, cc equal to the
  unsharded decode's), each path's launches checked shard by shard and
  no decline logged; (b) the step with a one-rank NCCL group; (c) two
  processes on the card over gloo (rank_main), and with two cards or
  more one process a card over NCCL; (d) steady times of the sharded
  decode and encode at 1 and 4 shards beside the unsharded calls, the
  gather paint's time and the memory high-water marks. Returns the
  launch counts of the 4-shard paths."""
  os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
  os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
  h = stream.head
  sx, sy, sz = h.sx, h.sy, h.sz
  b512, bu64, b256, bmkv = (read(p) for p in (VOL512, VOLU64, VOL256,
                                                VOLMKV))
  bp512 = read(paths["pins512"])
  orc = np.load(paths["stats"])
  cards = parallel.make_mesh()
  four = parallel.make_mesh([dev] * 4)
  meshes = {f"{len(cards.devices)}-card mesh": cards,
            "4 shards on one card": four}
  streams = [("512^3", b512, paths["512"], "flat"),
             ("pins 512^3", bp512, paths["512"], "pins"),
             ("u64 256^2x128", bu64, paths["u64"], "flat"),
             ("markov-5 256^2x128", bmkv, paths["mkv"], "flat")]
  # the long-slice volume: its slices, past MAX_DEVICE_CAP, taken whole
  # (as by the reference's sharded prep)
  streams.append(("long slices 2048^2x32", read(paths["long"][0]),
                  paths["long"][1], "flat"))
  runs = [(mt, m, st) for mt, m in meshes.items() for st in streams] + [
    ("3 shards on one card", parallel.make_mesh([dev] * 3),
     ("u32 256^2x128 (128 % 3 != 0)", b256, paths["256"], "flat"))]
  sharded = {}
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  base = torch.cuda.memory_allocated()
  with HostDeclines() as declines:
    for mtag, mesh, (tag, binary, npy, kind) in runs:
      ct.reset_launches()
      t0 = time.perf_counter()
      got = parallel.decompress_sharded(binary, mesh)
      ms = (time.perf_counter() - t0) * 1e3
      if got is None:
        raise AssertionError(f"{mtag}: decompress_sharded declined {tag}")
      require_volume(f"{mtag} decompress_sharded {tag}", got,
                     np.load(npy, mmap_mode="r"), pcodec.header(binary))
      n = require_launches(f"{mtag} decompress_sharded {tag}",
                           per_shard(mesh, kind))
      if mesh is four:
        sharded[f"decode {tag}"] = n
      say(17, f"{mtag}: decompress_sharded of {tag} equal to the oracle "
              f"(first call {ms:.3f} ms); launches {n}")
    del got
    want = dict(zip(orc["uniq"].tolist(), orc["count"].tolist()))
    for mtag, mesh in meshes.items():
      ct.reset_launches()
      if parallel.voxel_counts_sharded(b512, mesh) != want:
        raise AssertionError(f"{mtag}: voxel_counts_sharded of 512^3 differs "
                             f"from the oracle")
      n = require_launches(f"{mtag} voxel_counts_sharded", per_shard(mesh,
                                                                     "flat"))
      if mesh is four:
        sharded["voxel_counts 512^3"] = n
      say(17, f"{mtag}: voxel_counts_sharded of 512^3 equal to the oracle's "
              f"numpy counts of {len(want)} labels; launches {n}")

    labels, _, _ = stream.decode_window(0, sz)
    vol = labels.reshape(sz, sy, sx).permute(2, 1, 0)
    s64 = ct.upload_stream(bu64, dev)
    h64 = s64.head
    lab64, _, _ = s64.decode_window(0, h64.sz)
    v64 = lab64.reshape(h64.sz, h64.sy, h64.sx).permute(2, 1, 0)
    del s64
    for mtag, mesh in meshes.items():
      for tag, v, binary in (("512^3", vol, b512), ("u64 256^2x128", v64,
                                                     bu64)):
        ct.reset_launches()
        require_bytes(f"{mtag} compress_sharded of the {tag} labels on the "
                      f"card", parallel.compress_sharded(v, mesh), binary)
        n = require_launches(f"{mtag} compress_sharded {tag}", encode_launches(
          mesh, v.shape[2], v.shape[0] * v.shape[1]))
        if mesh is four:
          sharded[f"encode {tag}"] = n
        say(17, f"{mtag}: compress_sharded of the {tag} labels on the card "
                f"gives the committed stream's {len(binary)} bytes; "
                f"launches {n}")

    inputs = eng.prepare_slice_inputs(b512, 0, sz)
    _, cum, keys = eng._flat_label_tables(h, b512)
    args = (inputs["packed"], inputs["nbytes"], inputs["nodes"],
            inputs["n_chains"], keys, cum[:sz])
    perm = h.crack_format == ct.CrackFormat.PERMISSIBLE
    cc0, _, _ = ct.decode_window_ccl_device(b512, 0, sz, dev)
    for mtag, mesh in meshes.items():
      ct.reset_launches()
      cc, counts, z_index = parallel.sharded_roundtrip_step(
        mesh, sx, sy, perm)(*args)
      n = require_launches(f"{mtag} sharded_roundtrip_step", per_shard(
        mesh, "flat"))
      require_counts(f"{mtag} sharded_roundtrip_step", counts, orc)
      if not np.array_equal(z_index.cpu().numpy(), inputs["nbytes"]):
        raise AssertionError(f"{mtag}: z_index != the slices' byte lengths")
      require_equal(f"{mtag} sharded_roundtrip_step cc", cc, cc0)
      if mesh is four:
        sharded["roundtrip 512^3"] = n
      say(17, f"{mtag}: sharded_roundtrip_step of 512^3: counts equal to the "
              f"oracle's, z_index == nbytes, cc equal to "
              f"decode_window_ccl_device's; launches {n}")
    del cc
    ref = os.path.join(os.path.dirname(paths["stats"]), "sharded_ref.npz")
    np.savez(ref, counts=counts.cpu().numpy(), z_index=z_index.cpu().numpy())
  say(17, declines.require_none("sharded"))
  peak = torch.cuda.max_memory_allocated() - base
  say(17, f"(a) device memory high-water {peak} bytes ({peak / 2 ** 30:.3f} "
          f"GiB) above {base} bytes held before")

  # (b) the step with a one-rank NCCL group: its all_reduce and
  # all_gather_into_tensor run through NCCL on the card
  dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                          f"{free_port()}", world_size=1, rank=0)
  try:
    g = parallel.make_mesh([dev] * 4, group=dist.group.WORLD)
    step = parallel.sharded_roundtrip_step(g, sx, sy, perm)
    cc, counts, z_index = step(*args)
    require_counts("one-rank NCCL sharded_roundtrip_step", counts, orc)
    if not np.array_equal(z_index.cpu().numpy(), inputs["nbytes"]):
      raise AssertionError("one-rank NCCL: z_index != the slices' byte "
                           "lengths")
    require_equal("one-rank NCCL sharded_roundtrip_step cc", cc, cc0)
    del cc, cc0
    say(17, f"(b) one-rank nccl group ({dist.get_backend()}, NCCL "
            f"{torch.cuda.nccl.version()}, collectives on "
            f"{sharding.collective_device(g.group)}): "
            f"sharded_roundtrip_step on 4 shards gives (a)'s cc, counts and "
            f"z_index; device events of one step (torch.profiler; NCCL "
            f"runs a one-rank collective as a copy): "
            f"{device_events(lambda: step(*args))}")
  finally:
    dist.destroy_process_group()

  # (c) two processes on the card over gloo; with two cards or more, one
  # process a card over NCCL as well
  del counts, z_index
  runs = [("gloo", [f"cuda:{torch.cuda.current_device()}"] * 2)]
  if torch.cuda.device_count() >= 2:
    runs.append(("nccl", [f"cuda:{i}" for i in
                          range(torch.cuda.device_count())]))
  for backend, devices in runs:
    wall, lines = spawn_ranks(backend, devices, paths, ref)
    for line in lines:
      say(17, f"(c) {line}")
    say(17, f"(c) {len(devices)} processes over {backend} on {devices}: "
            f"compress_shard -> assemble_shards equal to the committed "
            f"512^3 bytes, decompress_shard of each window equal to the "
            f"oracle, all_gather of the windows' label histograms equal to "
            f"its counts, sharded_roundtrip_step across the ranks equal to "
            f"(a)'s; wall {wall:.3f} s")

  # (d) steady times beside the unsharded calls
  one = parallel.make_mesh([dev])
  ms = {"decompress_sharded 1 shard": wall_ms(
          lambda: parallel.decompress_sharded(b512, one), 3),
        "decompress_sharded 4 shards": wall_ms(
          lambda: parallel.decompress_sharded(b512, four), 3),
        "decode_window(0, 512, check_crcs=False)": wall_ms(
          lambda: ct.decode_window(b512, 0, sz, check_crcs=False,
                                   device=dev), 3)}
  enc_ms = {"compress_sharded 1 shard": wall_ms(
              lambda: parallel.compress_sharded(vol, one), 3),
            "compress_sharded 4 shards": wall_ms(
              lambda: parallel.compress_sharded(vol, four), 3),
            "codec.compress": wall_ms(lambda: pcodec.compress(vol), 3)}
  for what, d in (("decode of 512^3 to host numpy", ms),
                  ("encode of the 512^3 labels on the card", enc_ms)):
    say(17, f"(d) steady {what} (host clock, 3 runs after a warm one) ms: "
            + "; ".join(f"{k} " + ", ".join(f"{x:.3f}" for x in v)
                        + f" (mean {np.mean(v):.3f}, "
                          f"{sx * sy * sz / np.mean(v) / 1e3:.1f} MVx/s)"
                        for k, v in d.items()))
  uniq, cum, keys = eng._flat_label_tables(h, b512)
  cc, _, _ = ct.decode_window_ccl_device(b512, 0, sz, dev)
  tabs = eng._gather_tables(uniq, cum, keys, 0, sz, dev)
  gms = cuda_ms(lambda: dec.paint_labels_u32(cc, *tabs), 3)
  say(17, f"(d) the sharded flat decode's gather paint (paint_labels_u32: "
          f"keys[cc + offset] into the dictionary, plain torch indexing) "
          f"at B=512 of 512^3: {gms:.3f} ms (CUDA events, mean of 3)")
  return sharded


def spawn_ranks(backend, devices, paths, ref):
  """Run rank_main in one child process a device of devices over a
  group of backend, under RANK_TIMEOUT; fail on any rank that fails or
  hangs. Returns (the wall seconds, each rank's report line)."""
  tmp = os.path.dirname(paths["stats"])
  port = free_port()
  logs = [os.path.join(tmp, f"rank{r}_{backend}.log")
          for r in range(len(devices))]
  t0 = time.perf_counter()
  procs = []
  for r, (d, log) in enumerate(zip(devices, logs)):
    spec = {"rank": r, "world": len(devices), "port": port,
            "backend": backend, "device": d, "rows": paths["512"],
            "stats": paths["stats"], "ref": ref, "dir": tmp}
    with open(log, "w") as f:
      procs.append(subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank",
         json.dumps(spec)], cwd=ROOT, stdout=f, stderr=subprocess.STDOUT))
  try:
    while any(p.poll() is None for p in procs):
      if time.perf_counter() - t0 > RANK_TIMEOUT or any(
          p.returncode not in (None, 0) for p in procs):
        break
      time.sleep(0.1)
  finally:
    for p in procs:
      if p.poll() is None:
        p.kill()
      p.wait()
  wall = time.perf_counter() - t0
  lines = []
  for r, (p, log) in enumerate(zip(procs, logs)):
    with open(log) as f:
      out = f.read()
    if p.returncode != 0 or f"rank {r} OK" not in out:
      raise AssertionError(f"rank {r} of the {backend} run on {devices} "
                           f"failed ({p.returncode}) after {wall:.1f} s:\n"
                           f"{out[-6000:]}")
    lines += [x for x in out.splitlines() if x.startswith(f"rank {r} ")]
  return wall, lines


def rank_main(spec):
  """One rank of phase 17(c) (chip_smoke.py --rank SPEC, SPEC a JSON
  object: rank, world, port, backend, device, the oracle's 512^3 rows
  and statistics, the parent's (a) counts and z_index, a directory):
  compress_shard of its host_z_window of the 512^3 labels as a tensor on
  its device under set_engine('torch'); a barrier; rank 0 splices the
  shards (assemble_shards) into the committed stream's bytes;
  decompress_shard of its window on the device against the oracle; an
  all_gather of the windows' label histograms against the oracle's
  counts; sharded_roundtrip_step on 2 shards a rank across the ranks
  against (a)'s counts and z_index, its cc through the stored CRCs. No
  decline may be logged."""
  rank, world, backend = spec["rank"], spec["world"], spec["backend"]
  dev = torch.device(spec["device"])
  torch.cuda.set_device(dev)
  t_start = time.perf_counter()
  multihost.init_distributed(f"localhost:{spec['port']}", world, rank,
                             backend=backend)
  group = dist.group.WORLD
  b512 = read(VOL512)
  head = pcodec.header(b512)
  sx, sy, sz = head.sx, head.sy, head.sz
  rows = np.load(spec["rows"], mmap_mode="r")
  orc = np.load(spec["stats"])
  z0, z1 = multihost.host_z_window(sz, world, rank)
  t = torch.from_numpy(np.ascontiguousarray(rows[z0:z1]).view(np.int32)).to(
    dev)
  win = t.view(torch.uint32).reshape(z1 - z0, sy, sx).permute(2, 1, 0)
  torch.cuda.synchronize(dev)
  torch.cuda.reset_peak_memory_stats(dev)
  base = torch.cuda.memory_allocated(dev)
  secs = {}
  pcodec.set_engine("torch", device=dev)
  try:
    with HostDeclines() as declines:
      ct.reset_launches()
      t0 = time.perf_counter()
      shard = multihost.compress_shard(win)
      secs["compress_shard"] = time.perf_counter() - t0
      if not ct.LAUNCHES["ccl_paint"]:
        raise AssertionError(f"rank {rank}: compress_shard launched no "
                             f"ccl_paint")
      with open(os.path.join(spec["dir"], f"shard{rank}_{backend}.ckl"),
                "wb") as f:
        f.write(shard)
      dist.barrier()
      if rank == 0:
        parts = []
        for r in range(world):
          with open(os.path.join(spec["dir"], f"shard{r}_{backend}.ckl"),
                    "rb") as f:
            parts.append(f.read())
        t0 = time.perf_counter()
        require_bytes("assemble_shards of the ranks' shards",
                      multihost.assemble_shards(parts), b512)
        secs["assemble_shards"] = time.perf_counter() - t0
      dist.barrier()
      ct.reset_launches()
      t0 = time.perf_counter()
      out, (a, b) = multihost.decompress_shard(b512, world, rank)
      secs["decompress_shard"] = time.perf_counter() - t0
      dec_launches = launched_now()
    declines.require_none(f"rank {rank}")
  finally:
    pcodec.set_engine("auto")
  require_volume(f"rank {rank} decompress_shard [{a}, {b})", out, rows[a:b],
                 head)
  if not dec_launches.get("ccl_paint"):
    raise AssertionError(f"rank {rank}: decompress_shard did not run on the "
                         f"card: {dec_launches}")
  del out

  cdev = sharding.collective_device(group)
  uniq = torch.from_numpy(orc["uniq"].astype(np.int64)).to(dev)
  hist = torch.bincount(torch.searchsorted(
    uniq, t.reshape(-1).to(torch.int64) & 0xFFFFFFFF), minlength=len(uniq))
  hists = [torch.zeros_like(hist, device=cdev) for _ in range(world)]
  dist.all_gather(hists, hist.to(cdev))
  if not np.array_equal(torch.stack(hists).sum(0).cpu().numpy(),
                        orc["count"]):
    raise AssertionError(f"rank {rank}: gathered histograms differ from the "
                         f"oracle's counts")
  del t, win

  ref = np.load(spec["ref"])
  inputs = eng.prepare_slice_inputs(b512, z0, z1)
  _, cum, keys = eng._flat_label_tables(head, b512)
  mesh = parallel.make_mesh([dev] * 2, group=group)
  ct.reset_launches()
  t0 = time.perf_counter()
  cc, counts, z_index = parallel.sharded_roundtrip_step(
    mesh, sx, sy, head.crack_format == ct.CrackFormat.PERMISSIBLE)(
      inputs["packed"], inputs["nbytes"], inputs["nodes"],
      inputs["n_chains"], keys, cum[z0:z1])
  torch.cuda.synchronize(dev)
  secs["sharded_roundtrip_step"] = time.perf_counter() - t0
  require_launches(f"rank {rank} sharded_roundtrip_step",
                   per_shard(mesh, "flat"))
  if not (np.array_equal(counts.cpu().numpy(), ref["counts"])
          and np.array_equal(z_index.cpu().numpy(), ref["z_index"])):
    raise AssertionError(f"rank {rank}: the cross-rank step differs from "
                         f"(a)'s counts or z_index")
  eng.crc_gate(cc, eng._stored_crcs(head, b512, dev)[z0:z1], z0)
  peak = torch.cuda.max_memory_allocated(dev) - base
  check_no_reference()
  dist.destroy_process_group()
  print(f"rank {rank} of {world} ({backend}, {dev}, rows [{z0}, {z1})): "
        + ", ".join(f"{k} {v:.3f} s" for k, v in secs.items())
        + f"; process wall {time.perf_counter() - t_start:.3f} s; device "
          f"memory high-water {peak} bytes ({peak / 2 ** 30:.3f} GiB) above "
          f"the window's {base} bytes", flush=True)
  print(f"rank {rank} OK", flush=True)
  return 0


def start_ops_oracle(paths):
  """Start phase 18's host oracle in four child processes on the files
  phases 1-3 wrote: the host-loop VCG (4 and 6) of the flat 512^3,
  markov-5, u64 and long-slice streams in one, of the pins 512^3 stream
  in another, the contacts of the pins 512^3 stream and phase 19's
  CrackleArray edits in a third, and in the fourth the other contacts and
  the host functions of phase 18 (d).
  Writes (d)'s array_equal partner first: a copy of the 256^2 stream
  with its first slice moved last. Returns (the processes, the paths
  they write)."""
  tmp = os.path.dirname(paths["stats"])
  cells = dict(vcg_cells(paths))
  vcg = {(tag, c): os.path.join(tmp, f"vcg{c}_{i}.npy")
         for i, tag in enumerate(cells) for c in (4, 6)}
  contacts = {tag: os.path.join(tmp, f"contacts_{i}.npz")
              for i, (tag, _, _) in enumerate(CONTACT_CELLS)}
  b256 = read(VOL256)
  _, first, rest = ops.zsplit(b256, 0)
  rotated = os.path.join(tmp, "rotated256.ckl")
  with open(rotated, "wb") as f:
    f.write(ops.zstack([rest, first]))
  out = {"vcg": vcg, "contacts": contacts,
         "pairs": [(VOL256, VOL256), (VOL256, VOLMKV), (VOL256, rotated)],
         "each": os.path.join(tmp, "each.npz"),
         "mode_pooling": os.path.join(tmp, "pooled.ckl"),
         "cc": {c: os.path.join(tmp, f"cc{c}.ckl") for c in (6, 26)},
         "arrays": [os.path.join(tmp, f"arrays{i}.ckl") for i in range(4)],
         "json": [os.path.join(tmp, f"ops{i}.json") for i in range(4)]}
  # four children of about a minute each: the pins host loops are the
  # slowest
  an = {tag: a for tag, a, _ in CONTACT_CELLS}
  specs = [
    {"vcg": [[cells[tag], c, vcg[tag, c]] for tag in cells
             if tag != "pins 512^3" for c in (4, 6)]},
    {"vcg": [[cells["pins 512^3"], c, vcg["pins 512^3", c]]
             for c in (4, 6)]},
    {"contacts": [[cells["pins 512^3"], an["pins 512^3"],
                   contacts["pins 512^3"]]],
     "arrays": [VOL512, SET_INT, SET_BOX, SET_DATA, out["arrays"]]},
    {"contacts": [[cells[tag], an[tag], contacts[tag]]
                  for tag in an if tag != "pins 512^3"],
     "each": [VOL256, EACH_LABELS, out["each"]],
     "array_equal": out["pairs"],
     "mode_pooling": [VOL256, out["mode_pooling"]],
     "cc": [[VOL256, c, p] for c, p in out["cc"].items()]}]
  for spec, js in zip(specs, out["json"]):
    spec["json"] = js
  procs = [subprocess.Popen([sys.executable, "-c", ORACLE, json.dumps(spec)],
                            cwd=ROOT) for spec in specs]
  return procs, out


def vcg_cells(paths):
  """(tag, stream path) of phase 18 (a)'s streams."""
  return [("512^3", VOL512), ("pins 512^3", paths["pins512"]),
          ("markov-5 256^2x128", VOLMKV), ("u64 256^2x128", VOLU64),
          ("long slices 2048^2x32", paths["long"][0])]


# phase 18 (c): (tag, anisotropy, the path whose kernels it launches)
CONTACT_CELLS = [("512^3", (4, 4, 40), "vcg6"),
                 ("pins 512^3", (1, 1, 1), "vcg6 pins"),
                 ("u64 256^2x128", (0.3, 0.7, 1.1), "vcg6")]
# phase 18 (d): each of the first EACH_LABELS labels of the 256^2 stream
EACH_LABELS = 8


class CrcCount:
  """Counts the calls of crc32c.crc32c_rows (the encode's CRCs) and
  crc32c.crc32c_first_mismatch (the CRC gate) while it is entered."""

  NAMES = ("crc32c_rows", "crc32c_first_mismatch")

  def __enter__(self):
    self.n = 0
    self._fns = {name: getattr(crc32c, name) for name in self.NAMES}

    def counted(fn):
      def call(*a, **k):
        self.n += 1
        return fn(*a, **k)
      return call

    for name, fn in self._fns.items():
      setattr(crc32c, name, counted(fn))
    return self

  def __exit__(self, *exc):
    for name, fn in self._fns.items():
      setattr(crc32c, name, fn)


def take(total):
  """This step's launches, added to total; the counts start again at 0."""
  n = launched_now()
  for k, v in n.items():
    total[k] += v
  ct.reset_launches()
  return n


def require_path(what, n, path, only=False):
  """n holds every kernel of PATHS[path] (and, with only, no other)."""
  missing = [k for k in PATHS[path] if not n.get(k)]
  extra = [k for k in n if k not in PATHS[path]] if only else []
  if missing or extra:
    raise AssertionError(f"{what}: launches {n}, missing {missing}, "
                         f"unexpected {extra}")


def contacts_of(npz):
  z = np.load(npz)
  return {(int(a), int(b)): float(x) for a, b, x in
          zip(z["lo"].tolist(), z["hi"].tolist(), z["area"].tolist())}


def finish_ops_oracle(procs, out):
  """Wait for start_ops_oracle's children; returns (the paths they
  wrote, the seconds of each of their steps, their array_equal
  results)."""
  for proc in procs:
    if proc.wait(timeout=900) != 0:
      raise AssertionError(f"the operations oracle failed "
                           f"({proc.returncode})")
  secs, equal = {}, []
  for js in out["json"]:
    with open(js) as f:
      d = json.load(f)
    secs.update(d["secs"])
    equal += d["array_equal"]
  return out, secs, equal


def phase_operations(dev, ops_oracle, paths):
  """Phase 18: the stream operations and analytics under
  set_engine('torch') on dev against the oracle children of
  start_ops_oracle; see the module docstring. Returns the launches of
  each step's first call, summed."""
  out, secs, equal = ops_oracle
  say(18, "operations oracle's seconds: " + ", ".join(
    f"{k} {v:.3f}" for k, v in secs.items()))
  streams = {tag: (os.path.basename(p), read(p)) for tag, p in
             vcg_cells(paths)}
  total = {name: 0 for name in ct.LAUNCHES}
  pcodec.set_engine("torch", device=dev)
  try:
    with HostDeclines() as declines:
      ct.reset_launches()
      with CrcCount() as crcs:
        vcg_lines(streams, out, secs, total)
        if crcs.n:
          raise AssertionError(f"the VCG route ran the CRC gate {crcs.n} "
                               f"times")
        b512 = streams["512^3"][1]
        renum = ops.renumber(b512, start=1)[0]
        _, first, rest = ops.zsplit(b512, 0)
        for tag, other, want in (("renumbered", renum, True),
                                 ("first slice moved last",
                                  ops.zstack([rest, first]), False)):
          t0 = time.perf_counter()
          got = ops.structure_equal(b512, other)
          ms = (time.perf_counter() - t0) * 1e3
          if got is not want:
            raise AssertionError(f"structure_equal(512^3, {tag}) is {got}")
          n = take(total)
          say(18, f"(b) structure_equal(512^3, {tag}) is {got} as it should "
                  f"be ({ms:.3f} ms; launches {n})")
        contact_lines(streams, out, secs, total)
        if crcs.n:
          raise AssertionError(f"the contacts route ran the CRC gate "
                               f"{crcs.n} times")
      host_function_lines(out, secs, equal, total)
      edit_lines(b512, paths, total, dev)
    say(18, declines.require_none("operations"))
  finally:
    pcodec.set_engine("auto")
  say(18, f"operations-path launches (each step's first call) {total}")
  return total


def vcg_lines(streams, out, secs, total):
  """Phase 18 (a): voxel_connectivity_graph of each stream against the
  host loop, its launches, steady times and busy share."""
  for tag, (fname, binary) in streams.items():
    head = pcodec.header(binary)
    vox = head.sx * head.sy * head.sz
    pins = head.label_format == 2
    for c in (4, 6):
      t0 = time.perf_counter()
      got = ops.voxel_connectivity_graph(binary, c)
      first = (time.perf_counter() - t0) * 1e3
      n = take(total)
      want = np.load(out["vcg"][tag, c], mmap_mode="r")
      if got.dtype != np.uint8 or got.shape != (head.sx, head.sy, head.sz) \
         or not np.array_equal(got.transpose(2, 1, 0), want):
        raise AssertionError(f"{tag} vcg{c} differs from the host loop")
      require_path(f"{tag} vcg{c}", n, "vcg4" if c == 4 else
                   "vcg6 pins" if pins else "vcg6", only=True)
      ms = wall_ms(lambda: ops.voxel_connectivity_graph(binary, c), 3)
      wall, busy, nev = busy_split(
        lambda: ops.voxel_connectivity_graph(binary, c))
      ct.reset_launches()
      mean = sum(ms) / len(ms)
      name = f"vcg{c} {fname}"
      say(18, f"(a) {tag} voxel_connectivity_graph({c}) byte-equal to the "
              f"host loop (oracle {secs.get(name, float('nan')):.3f} s); "
              f"first call {first:.3f} ms; steady ms "
              + ", ".join(f"{x:.3f}" for x in ms)
              + f"; mean {mean:.3f} ms, {vox / mean / 1e3:.1f} MVx/s; one "
                f"profiled call {wall:.3f} ms of wall, device busy "
              + (f"{busy:.3f} ms ({100 * busy / wall:.1f}%), host the rest"
                 if busy is not None else "not measured")
              + f" ({nev} device events); launches {n}")


def contact_lines(streams, out, secs, total):
  """Phase 18 (c): contacts of each CONTACT_CELLS stream, == the host
  loop's dict, with its launches and wall times."""
  for tag, an, path in CONTACT_CELLS:
    fname, binary = streams[tag]
    t0 = time.perf_counter()
    got = ops.contacts(binary, an)
    first = time.perf_counter() - t0
    n = take(total)
    want = contacts_of(out["contacts"][tag])
    if got != want:
      raise AssertionError(f"{tag} contacts{an} differ from the host loop "
                           f"({len(got)} pairs against {len(want)})")
    require_path(f"{tag} contacts", n, path, only=True)
    ms = wall_ms(lambda: ops.contacts(binary, an), 2)
    ct.reset_launches()
    name = f"contacts {fname}"
    say(18, f"(c) {tag} contacts{an}: {len(got)} pairs, == the host loop's "
            f"dict (oracle {secs.get(name, float('nan')):.3f} s); wall "
            f"first {first:.3f} s, then " + ", ".join(
              f"{x / 1e3:.3f}" for x in ms) + f" s; launches {n}")


def host_function_lines(out, secs, equal, total):
  """Phase 18 (d): each, array_equal, mode_pooling_2x2x1 and
  connected_components of the 256^2 stream under the torch engine,
  against the oracle's."""
  b256 = read(VOL256)
  t0 = time.perf_counter()
  labels = [int(u) for u in pcodec.labels(b256)[:EACH_LABELS]]
  imgs = dict(ct.each(b256, labels=labels))
  t_each = time.perf_counter() - t0
  want = np.load(out["each"])
  if sorted(map(str, imgs)) != sorted(want.files):
    raise AssertionError("each: other labels than the oracle's")
  for k, img in imgs.items():
    w = want[str(k)]
    if img.dtype != w.dtype or not np.array_equal(img, w):
      raise AssertionError(f"each: the image of label {k} differs")
  n = take(total)
  require_path("each", n, "flat")
  say(18, f"(d) each of {len(imgs)} labels, cropped, equal to the oracle's "
          f"images ({t_each:.3f} s; oracle {secs['each']:.3f} s); "
          f"launches {n}")
  got = []
  t0 = time.perf_counter()
  for a, b in out["pairs"]:
    got.append(ops.array_equal(read(a), read(b)))
  t_eq = time.perf_counter() - t0
  if got != equal or got != [True, True, False]:
    raise AssertionError(f"array_equal {got}, oracle {equal}")
  n = take(total)
  t_or = sum(v for k, v in secs.items() if k.startswith("array_equal"))
  say(18, f"(d) array_equal of the 256^2 stream with itself, its markov-5 "
          f"stream and a copy with its first slice last: {got}, as the "
          f"oracle's ({t_eq:.3f} s; oracle {t_or:.3f} s); launches {n}")
  steps = [("mode_pooling_2x2x1", lambda: ops.mode_pooling_2x2x1(b256),
            out["mode_pooling"])]
  steps += [(f"connected_components {c}",
             lambda c=c: ops.connected_components(b256, c), p)
            for c, p in out["cc"].items()]
  for step, fn, path in steps:
    t0 = time.perf_counter()
    got = fn()
    t = time.perf_counter() - t0
    require_bytes(step, got, read(path))
    n = take(total)
    require_path(step, n, "encode")
    say(18, f"(d) {step} of the 256^2 stream: the oracle's {len(got)} bytes "
            f"({t:.3f} s; oracle {secs[step]:.3f} s); launches {n}")


def edit_lines(b512, paths, total, dev):
  """Phase 18 (e): remap, renumber, mask and zsplit of 512^3 decoded on
  the card with the CRC gate, against the oracle volume with the same
  edit in numpy."""
  want = np.load(paths["512"], mmap_mode="r")
  uniq = pcodec.labels(b512)

  def lookup(vals, dtype):
    return np.asarray(vals, dtype)[np.searchsorted(uniq, want)]

  renum, mapping = ops.renumber(b512, start=1)
  masked = uniq[::200]
  before, mid, after = ops.zsplit(b512, 200)
  edits = [
    ("remap (labels reversed)", ops.remap(
      b512, dict(zip(uniq.tolist(), uniq[::-1].tolist()))),
     lambda: lookup(uniq[::-1], uniq.dtype)),
    ("renumber from 1", renum, lambda: lookup(
      [mapping[int(u)] for u in uniq], pcodec.header(renum).dtype)),
    (f"mask of {len(masked)} labels", ops.mask(b512, masked.tolist()),
     lambda: np.where(np.isin(want, masked), 0, want).astype(uniq.dtype)),
    ("zsplit(200) before", before, lambda: want[:200]),
    ("zsplit(200) slice", mid, lambda: want[200:201]),
    ("zsplit(200) after", after, lambda: want[201:])]
  for tag, binary, expect in edits:
    head = pcodec.header(binary)
    t0 = time.perf_counter()
    got = ct.decode_window(binary, 0, head.sz, check_crcs=True, device=dev)
    t = time.perf_counter() - t0
    require_volume(f"edited 512^3: {tag}", got, expect(), head)
    n = take(total)
    require_path(tag, n, "flat")
    say(18, f"(e) {tag}: decode_window(0, {head.sz}, check_crcs=True) on "
            f"the card equal to the oracle volume edited in numpy "
            f"({head.dtype}; {t:.3f} s); launches {n}")


# phase 19: CrackleArray cutouts of the flat 512^3 stream (numpy's
# indexing and CrackleArray's agree on these), the edits the oracle
# repeats (an int over whole slices, past the first 8, which the zstack
# seam's cutout reads as they were; an array over a box), the pins
# cutout, the remote array's slices and the slice the CLI's -T must name
ARRAY_CUTOUTS = [":, :, :", "100:300, 50:450, 200:264", ":, :, 300",
                 ":, :, ::3"]
SET_INT = ":, :, 200:264"
SET_BOX = "100:300, 50:450, 200:264"
SET_DATA = "100:300, 50:450, 0:64"
PINS_CUTOUT = "100:300, 50:450, 200:264"
REMOTE_Z = (0, 255, 511)
CRACK_Z = 317
TRACE_Z = (0, 64)


def flip_crack_byte(binary, z):
  """binary with a byte in the middle of slice z's crack code flipped,
  its stored CRC as it was."""
  head = pcodec.header(binary)
  codes = pcodec.crack_codes(binary)
  trailer = (head.sz + 1) * 4 if head.format_version else 0
  end = len(binary) - trailer - sum(len(c) for c in codes[z + 1:])
  out = bytearray(binary)
  out[end - len(codes[z]) + len(codes[z]) // 2] ^= 0x5A
  return bytes(out)


def payload(path):
  """A file's bytes through its compression suffix."""
  import gzip
  import lzma
  opener = {".gz": gzip.open, ".xz": lzma.open}.get(
    os.path.splitext(path)[1], open)
  with opener(path, "rb") as f:
    return f.read()


def item_line(what, fn, check, path, total, card, profile=True):
  """One phase-19 item: its first call, checked by check(result) and its
  launches by require_path(path); then 3 calls on the host clock,
  the card synchronised after each, and (with profile) one profiled
  call's busy share; the launch counts start again at 0 and the first
  call's are added to total."""
  ct.reset_launches()
  t0 = time.perf_counter()
  got = fn()
  torch.cuda.synchronize()
  first = (time.perf_counter() - t0) * 1e3
  n = take(total)
  check(got)
  if path is not None:
    require_path(what, n, path)
  del got
  ms = []
  for _ in range(3):
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    ms.append((time.perf_counter() - t0) * 1e3)
  if profile:
    wall, busy, nev = busy_split(fn)
    shared = (f"one profiled call {wall:.3f} ms of wall, device busy "
              + (f"{busy:.3f} ms ({100 * busy / wall:.1f}%)"
                 if busy is not None else "not measured")
              + f" ({nev} device events)")
  else:
    shared = "busy share in a fresh process (below)"
  ct.reset_launches()
  mean = sum(ms) / len(ms)
  say(19, f"{what}: equal to the oracle; first call {first:.3f} ms; steady "
          f"ms " + ", ".join(f"{x:.3f}" for x in ms) + f"; mean {mean:.3f} "
          f"ms; {shared}; launches {n} ({card})")


def require_array(what, got, want):
  if not isinstance(got, np.ndarray) or got.dtype != want.dtype or \
     got.shape != want.shape or not np.array_equal(got, want):
    raise AssertionError(
      f"{what}: {type(got).__name__} {getattr(got, 'dtype', None)} "
      f"{getattr(got, 'shape', None)} differs from the oracle's "
      f"{want.dtype} {want.shape}")


def phase_arrays(dev, stream, paths, ops_oracle, card):
  """Phase 19: the host arrays, util, the CLI and profiling under
  set_engine('torch') on dev, against the oracle's volume and bytes; see
  the module docstring. Returns the launches of each item's first call,
  summed."""
  from click.testing import CliRunner
  from crackle_tpu_torch import cli
  from crackle_tpu_torch.utils import profiling
  out = ops_oracle[0]
  set_int, set_box, comp, stacked = (read(p) for p in out["arrays"])
  b512, bp512 = read(VOL512), read(paths["pins512"])
  head = pcodec.header(b512)
  sx, sy, sz = head.sx, head.sy, head.sz
  vol = np.load(paths["512"]).reshape(sz, sy, sx).transpose(2, 1, 0)
  orc = np.load(paths["stats"])
  total = {name: 0 for name in ct.LAUNCHES}
  tmp = tempfile.mkdtemp(dir=os.path.dirname(paths["stats"]))
  pcodec.set_engine("torch", device=dev)
  try:
    with HostDeclines() as declines:
      arr = ct.CrackleArray(b512)
      # (a) cutouts
      for key in ARRAY_CUTOUTS:
        want = vol[eval(f"np.s_[{key}]")]
        item_line(f"(a) CrackleArray(512^3)[{key}]",
                  lambda key=key: arr[eval(f"np.s_[{key}]")],
                  lambda got, want=want: require_array(key, got, want),
                  "flat", total, card)
      wide = ct.CrackleArray(b512)
      if wide[..., np.newaxis] is not wide or wide.shape != (sx, sy, sz, 1):
        raise AssertionError("[..., np.newaxis] did not add a trailing axis")
      item_line("(a) CrackleArray(512^3)[..., np.newaxis][:, :, 10:20]",
                lambda: wide[:, :, 10:20],
                lambda got: require_array("newaxis", got,
                                          vol[:, :, 10:20, np.newaxis]),
                "flat", total, card)
      # (b) edits
      for tag, key, data, want, path in (
          # the int edit encodes only; the box one decodes its window first
          ("int", SET_INT, lambda: 0, set_int, "encode"),
          ("array", SET_BOX, lambda: np.array(vol[eval(f"np.s_[{SET_DATA}]")]),
           set_box, "flat")):
        def edit(key=key, data=data):
          a = ct.CrackleArray(b512)
          a[eval(f"np.s_[{key}]")] = data()
          return a.binary
        item_line(f"(b) CrackleArray(512^3)[{key}] = {tag}", edit,
                  lambda got, want=want, tag=tag: require_bytes(
                    f"the {tag} edit", got, want), path, total, card)
      # (c) statistics on the card
      stats = {}
      for fn in ("voxel_counts", "centroids", "bounding_boxes"):
        kw = {"no_slice_conversion": True} if fn == "bounding_boxes" else {}
        item_line(f"(c) CrackleArray(512^3).{fn}()",
                  lambda fn=fn, kw=kw: getattr(arr, fn)(**kw),
                  lambda got, fn=fn: stats.__setitem__(fn, got),
                  "analytics", total, card)
      check_analytics(orc, stats["voxel_counts"], stats["centroids"],
                      stats["bounding_boxes"])
      say(19, "(c) voxel_counts and bounding_boxes equal to the numpy "
              "oracle, centroids within rtol 1e-12")
      # (d) compressa, zstack
      item_line("(d) compressa(512^3 labels)", lambda: ct.compressa(vol),
                lambda got: require_bytes("compressa", got.binary, comp),
                "encode", total, card)
      item_line("(d) zstack([CrackleArray(512^3), CrackleArray(512^3 "
                "edited)])", lambda: ct.zstack(
                  [arr, ct.CrackleArray(set_int)]),
                lambda got: require_bytes("zstack", got, stacked), None,
                total, card)
      seam = ct.CrackleArray(stacked)
      item_line(f"(d) CrackleArray(zstack)[:, :, {sz - 12}:{sz + 8}] "
                f"across the seam", lambda: seam[:, :, sz - 12:sz + 8],
                lambda got: require_array("the seam", got, np.concatenate(
                  [vol[:, :, sz - 12:], vol[:, :, 0:8]], axis=2)),
                "flat", total, card)
      # (e) pins
      pins = ct.CrackleArray(bp512)
      item_line(f"(e) CrackleArray(pins 512^3)[{PINS_CUTOUT}]",
                lambda: pins[eval(f"np.s_[{PINS_CUTOUT}]")],
                lambda got: require_array("pins cutout", got,
                                          vol[eval(f"np.s_[{PINS_CUTOUT}]")]),
                "pins", total, card)
      # (f) the remote array over a file
      ckl = os.path.join(tmp, "vol.ckl")
      with open(ckl, "wb") as f:
        f.write(b512)
      remote = ct.CrackleRemoteArray(ckl)
      for z in REMOTE_Z:
        item_line(f"(f) CrackleRemoteArray(512^3 file)[{z}]",
                  lambda z=z: remote[z],
                  lambda got, z=z: require_array(f"remote z={z}", got,
                                                 vol[:, :, z]),
                  "flat", total, card)
      uniq = pcodec.labels(b512)
      if not np.array_equal(remote.labels(), uniq) or \
         remote.num_labels() != len(uniq) or int(uniq[7]) not in remote or \
         int(uniq.max()) + 1 in remote:
        raise AssertionError("the remote array's labels differ")
      n = take(total)
      say(19, f"(f) CrackleRemoteArray labels(), num_labels() ({len(uniq)}) "
              f"and `in` equal to the stream's; launches {n}")
      # (g) util round trips
      for ext in (".ckl", ".ckl.gz", ".ckl.xz"):
        path = os.path.join(tmp, "saved" + ext)

        def save_load(path=path):
          ct.save(ct.CrackleArray(b512), path)
          return ct.load(path)
        item_line(f"(g) save(CrackleArray, '{ext}') and load", save_load,
                  lambda got: require_array("load", got, vol), "flat",
                  total, card)
        if payload(path) != b512 or ct.bload(path) != b512 or \
           ct.aload(path).binary != b512:
          raise AssertionError(f"{ext}: bload or aload differ from the "
                               f"stream")
        if ext == ".ckl":
          z = REMOTE_Z[1]
          require_array("rload", ct.rload(path)[z], vol[:, :, z])
        n = take(total)
        say(19, f"(g) {ext}: the file holds the stream's bytes; bload, "
                f"aload" + (" and rload" if ext == ".ckl" else "")
                + f" equal; launches {n}")
      npy = os.path.join(tmp, "saved.npy")
      item_line("(g) save_numpy(CrackleArray(512^3))",
                lambda: ct.save_numpy(ct.CrackleArray(b512), npy),
                lambda got: require_array("save_numpy", np.load(npy), vol),
                "flat", total, card)
      # (h) the CLI in-process, the codec's engine at its default ('auto',
      # which the CLI turns into 'torch' on the card); the busy shares of
      # the items after the first -T in a fresh process (see busy_main)
      pcodec.set_engine("auto")
      cdir = os.path.join(tmp, "cli")
      os.makedirs(cdir)
      cwd = os.getcwd()
      os.chdir(cdir)
      try:
        with open("vol.ckl", "wb") as f:
          f.write(b512)
        with open("cracked.ckl", "wb") as f:
          f.write(flip_crack_byte(b512, CRACK_Z))

        def run_cli(*args):
          return CliRunner().invoke(cli.main, list(args))

        def expect(code, *texts):
          def check(res):
            if res.exception is not None and \
               not isinstance(res.exception, SystemExit):
              raise res.exception
            if res.exit_code != code or any(t not in res.output
                                            for t in texts):
              raise AssertionError(f"exit {res.exit_code}: "
                                   f"{res.output[-500:]}")
          return check

        item_line("(h) crackle-torch -i vol.ckl", lambda: run_cli(
          "-i", "vol.ckl"), expect(0, f"num labels:    {len(uniq)}"), None,
          total, card)
        item_line("(h) crackle-torch -l vol.ckl", lambda: run_cli(
          "-l", "vol.ckl"), expect(0, "\n".join(str(int(u)) for u in uniq)),
          None, total, card)
        item_line("(h) crackle-torch -T vol.ckl", lambda: run_cli(
          "-T", "vol.ckl"), expect(0, "vol.ckl: OK"), "flat", total, card)
        item_line(f"(h) crackle-torch -T cracked.ckl (slice {CRACK_Z})",
                  lambda: run_cli("-T", "cracked.ckl"),
                  expect(1, "cracked.ckl: CORRUPTED",
                         f"damaged z slices: [{CRACK_Z}]"), "flat", total,
                  card, profile=False)
        item_line("(h) crackle-torch -d -k vol.ckl", lambda: run_cli(
          "-d", "-k", "vol.ckl"), lambda res: (expect(0, "wrote vol.npy")(
            res), require_array("-d", np.load("vol.npy"), vol)), "flat",
          total, card, profile=False)
        os.replace("vol.npy", "labels.npy")

        def compress_cli():
          res = run_cli("-k", "labels.npy")
          expect(0, "wrote labels.ckl")(res)
          return read("labels.ckl")
        item_line("(h) crackle-torch -k labels.npy", compress_cli,
                  lambda got: require_bytes("the CLI's compress", got, comp),
                  "encode", total, card, profile=False)
      finally:
        os.chdir(cwd)
        pcodec.set_engine("torch", device=dev)
      busy_cli(cdir, card)
      # (i) profiling: trace() in a process of its own (see trace_main)
      t0 = time.perf_counter()
      proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--trace", json.dumps(
          {"ckl": VOL512, "rows": paths["512"], "z": TRACE_Z,
           "device": str(dev), "dir": os.path.join(tmp, "trace")})],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
      ok = [x for x in proc.stdout.splitlines() if x.startswith("trace OK ")]
      if proc.returncode != 0 or not ok:
        raise AssertionError(f"the trace child failed ({proc.returncode}):"
                             f"\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
      rep = json.loads(ok[0][len("trace OK "):])
      for k, v in rep["launches"].items():
        total[k] += v
      say(19, f"(i) profiling.trace() of CrackleArray(512^3)[:, :, "
              f"{TRACE_Z[0]}:{TRACE_Z[1]}] in a fresh process "
              f"({rep['ms']:.3f} ms traced; the child "
              f"{time.perf_counter() - t0:.1f} s): equal to the oracle, and "
              f"its Chrome trace names the annotate span and the kernels of "
              f"every launched wrapper {rep['launches']} "
              f"({rep['events']} events, {rep['kernels']} kernel events)")
      with profiling.timer(sync=stream.packed) as box:
        stream.decode_window(0, sz, check_crcs=True)
      with profiling.timer(sync=stream.packed) as empty:
        pass
      say(19, f"(i) profiling.timer(sync=tensor) around decode_window(0, "
              f"{sz}, check_crcs=True): {box['seconds'] * 1e3:.3f} ms; "
              f"around nothing {empty['seconds'] * 1e3:.3f} ms ({card})")
    say(19, declines.require_none("host-array"))
  finally:
    pcodec.set_engine("auto")
  say(19, f"host-array launches (each item's first call) {total}")
  missing = [k for k in PATHS["flat"] + PATHS["pins"] + ("slice_stats",)
             if not total[k]]
  if missing:
    raise AssertionError(f"phase 19 launched none of {missing}")
  return total


# the CLI's command lines whose busy share busy_main takes, each with its
# exit code and the path its launches must show; -T last (see busy_main)
BUSY_CLI = [(["-d", "-k", "vol.ckl"], 0, "flat"),
            (["-k", "labels.npy"], 0, "encode"),
            (["-T", "cracked.ckl"], 1, "flat")]


def busy_cli(cdir, card):
  """Phase 19 (h): one profiled call of each of BUSY_CLI in the CLI's
  directory cdir, in a process of its own (busy_main)."""
  t0 = time.perf_counter()
  proc = subprocess.run(
    [sys.executable, os.path.abspath(__file__), "--busy", json.dumps(
      {"dir": cdir, "commands": BUSY_CLI})],
    cwd=ROOT, capture_output=True, text=True, timeout=300)
  ok = [x for x in proc.stdout.splitlines() if x.startswith("busy OK ")]
  if proc.returncode != 0 or not ok:
    raise AssertionError(f"the busy child failed ({proc.returncode}):"
                         f"\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
  for (args, _, path), r in zip(BUSY_CLI, json.loads(ok[0][len("busy OK "):])):
    what = "(h) crackle-torch " + " ".join(args)
    require_path(what, r["launches"], path)
    wall, busy = r["wall"], r["busy"]
    say(19, f"{what} in a fresh process, the codec's engine at its default: "
            f"one profiled call {wall:.3f} ms of wall, device busy "
            + (f"{busy:.3f} ms ({100 * busy / wall:.1f}%)"
               if busy is not None else "not measured")
            + f" ({r['events']} device events); launches {r['launches']} "
            f"({card})")
  say(19, f"(h) the busy child took {time.perf_counter() - t0:.1f} s")


def busy_main(spec):
  """Phase 19 (h) (chip_smoke.py --busy SPEC, SPEC a JSON object: the
  CLI's directory and BUSY_CLI): one profiled call of each command line
  through click's CliRunner, the codec's engine left at its default, after
  an unprofiled call of each but the last. A process of its own, and the
  -T last, since torch.profiler (2.11 on the H100 machine) drops the
  kernel records of later sessions once the process has recorded a
  session of some 10^5 device events, as a -T of 512^3 is."""
  from click.testing import CliRunner
  from crackle_tpu_torch import cli
  if pcodec.get_engine() != "auto":
    raise AssertionError(f"the engine is {pcodec.get_engine()}, not auto")
  os.chdir(spec["dir"])

  def run(args, code):
    res = CliRunner().invoke(cli.main, args)
    if res.exception is not None and \
       not isinstance(res.exception, SystemExit):
      raise res.exception
    if res.exit_code != code:
      raise AssertionError(f"{args}: exit {res.exit_code}: "
                           f"{res.output[-500:]}")
  out = []
  with HostDeclines() as declines:
    for args, code, _ in spec["commands"][:-1]:
      run(args, code)
    for args, code, _ in spec["commands"]:
      ct.reset_launches()
      wall, busy, nev = busy_split(lambda: run(args, code))
      out.append({"wall": wall, "busy": busy, "events": nev,
                  "launches": launched_now()})
  declines.require_none("the CLI's")
  check_no_reference()
  print("busy OK " + json.dumps(out), flush=True)
  return 0


def trace_main(spec):
  """Phase 19 (i) (chip_smoke.py --trace SPEC, SPEC a JSON object: the
  stream, the oracle's rows of it, the cutout's z range, the device, a
  directory): profiling.trace() around an annotated CrackleArray cutout
  [:, :, z0:z1] under set_engine('torch') on the device, after a warm
  one; its Chrome trace must name the annotate span and a device kernel
  (DEVICE_KERNELS) of every wrapper LAUNCHES counted. A process of
  its own, since torch.profiler (2.11 on the H100 machine) drops the first
  kernel records of a session once the process has recorded sessions of
  some 10^5 device events, as phase 19 (h)'s profiled -T calls are."""
  from crackle_tpu_torch.utils import profiling
  dev = torch.device(spec["device"])
  binary = read(spec["ckl"])
  head = pcodec.header(binary)
  rows = np.load(spec["rows"], mmap_mode="r")
  z0, z1 = spec["z"]
  pcodec.set_engine("torch", device=dev)
  arr = ct.CrackleArray(binary)
  cut = profiling.annotate("crackle_array_cutout")(lambda: arr[:, :, z0:z1])
  cut()
  torch.cuda.synchronize()
  ct.reset_launches()
  t0 = time.perf_counter()
  with profiling.trace(spec["dir"]) as d:
    got = cut()
  ms = (time.perf_counter() - t0) * 1e3
  n = launched_now()
  require_volume("the traced cutout", got, rows[z0:z1], head)
  require_path("the traced cutout", n, "flat")
  names = trace_names(d)
  missing = [k for k in n if not any(
    f"{dk}_kernel" in e for dk in DEVICE_KERNELS[k] for e in names)]
  if missing or "crackle_array_cutout" not in names:
    raise AssertionError(f"the trace lacks {missing} or the span "
                         f"({len(names)} events)")
  check_no_reference()
  kernels = sum(1 for e in names if "_kernel" in e)
  print("trace OK " + json.dumps({"launches": n, "ms": ms,
                                  "events": len(names), "kernels": kernels}),
        flush=True)
  return 0


def trace_names(log_dir):
  """The event names of the Chrome trace profiling.trace wrote."""
  import glob
  (path,) = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
  with open(path) as f:
    return [e.get("name", "") for e in json.load(f)["traceEvents"]]


def long_stage_line(binary, head, split, piece_z, cc, uniq, cum, keys, dev):
  """Host and device times of each stage of the long-slice decode."""
  sx, sy, sz = head.sx, head.sy, head.sz
  perm = head.crack_format == ct.CrackFormat.PERMISSIBLE
  host = {}
  t0 = time.perf_counter()
  eng.prepare_slice_inputs(binary, 0, sz)
  host["prepare_slice_inputs"] = time.perf_counter() - t0
  t0 = time.perf_counter()
  eng.prepare_split_inputs(binary, 0, sz)
  host["prepare_split_inputs"] = time.perf_counter() - t0
  t0 = time.perf_counter()
  eng._flat_label_tables(head, binary)
  host["label tables"] = time.perf_counter() - t0
  t = eng.params_from_jax(split, device=dev, piece_z=piece_z)
  ids = dec._edge_ids(t["packed"], t["nbytes"], t["nodes"], t["n_chains"],
                      sx, sy)
  rows = dec.slice_rows(ids, t["piece_z"], sz)
  vcg = replay.paint_vcg(rows, sx, sy, perm)
  off, k64, u32 = eng._gather_tables(uniq, cum, keys, 0, sz, dev)
  stored = eng._stored_crcs(head, binary, dev)
  labels = dec.paint_labels_u32(cc, off, k64, u32)
  dev_ms = {
    "replay (pieces)": cuda_ms(lambda: dec._edge_ids(
      t["packed"], t["nbytes"], t["nodes"], t["n_chains"], sx, sy), 3),
    "slice_rows": cuda_ms(lambda: dec.slice_rows(ids, t["piece_z"], sz), 3),
    "paint_vcg": cuda_ms(lambda: replay.paint_vcg(rows, sx, sy, perm), 3),
    "ccl_paint": cuda_ms(lambda: ccl.ccl_paint(vcg), 3),
    "crc32c": cuda_ms(lambda: eng.crc_gate(cc, stored, 0), 3),
    "paint_labels_u32": cuda_ms(lambda: dec.paint_labels_u32(
      cc, off, k64, u32), 3),
  }
  copy = wall_ms(lambda: eng._host_volume(labels, head, sz), 3)
  return (f"long-slice stages: host s " + ", ".join(
    f"{k} {v:.3f}" for k, v in host.items())
    + "; device ms (CUDA events, mean of 3) " + ", ".join(
      f"{k} {v:.3f}" for k, v in dev_ms.items())
    + f"; labels to the host {sum(copy) / len(copy):.3f} ms (host clock); "
      f"merged rows {tuple(rows.shape)}, paint in "
      f"{replay.paint_grid(sz, sx, sy, _build.sm_count(dev))[0]} bands a "
      f"slice")


def check_analytics(orc, vc, cen, bb):
  uniq = [int(u) for u in orc["uniq"]]
  for what, got in (("voxel_counts", vc), ("centroids", cen),
                    ("bounding_boxes", bb)):
    if sorted(got) != uniq:
      raise AssertionError(f"{what}: labels differ from the oracle's")
  count = orc["count"]
  if [vc[u] for u in uniq] != count.tolist():
    raise AssertionError("voxel_counts differ from the oracle")
  want = np.stack([orc[k] for k in ("min_x", "min_y", "min_z", "max_x",
                                    "max_y", "max_z")], 1)
  got = np.stack([bb[u].astype(np.int64) for u in uniq])
  if not np.array_equal(got, want):
    raise AssertionError("bounding_boxes differ from the oracle")
  want = np.stack([orc[k] / count for k in ("sum_x", "sum_y", "sum_z")], 1)
  got = np.array([cen[u] for u in uniq])
  np.testing.assert_allclose(got, want, rtol=1e-12)


def stage_times(s):
  """Device ms of each stage of one full-volume flat decode."""
  h = s.head
  ev, cls, dr = replay.replay_keys(s.packed, s.nbytes, s.n_chains)
  ids = replay.replay_positions(ev, cls, dr, s.nodes, h.sx, h.sy)
  vcg = replay.paint_vcg(ids, h.sx, h.sy, s.permissible)
  cc, _, _ = ccl.ccl_paint(vcg, s.T)
  return {
    "replay_keys": cuda_ms(lambda: replay.replay_keys(
      s.packed, s.nbytes, s.n_chains), 3),
    "replay_positions": cuda_ms(lambda: replay.replay_positions(
      ev, cls, dr, s.nodes, h.sx, h.sy), 3),
    "paint_vcg": cuda_ms(lambda: replay.paint_vcg(
      ids, h.sx, h.sy, s.permissible), 3),
    "ccl_paint": cuda_ms(lambda: ccl.ccl_paint(vcg, s.T), 3),
    "crc32c": cuda_ms(lambda: crc32c.crc32c_rows(cc), 3),
  }


def replay_stage_line(s, stages):
  """The replay stage (packed diffs -> edge ids) at B = sz against one
  yardstick for both designs: the whole stage's bound (packed, nbytes,
  n_chains and nodes read once, the ids written once; the two kernels'
  operation floors), and the torch.sort of the int64 keys that the
  parent design ran between its kernels, timed on the same events."""
  h = s.head
  B, CAP = s.packed.shape[0], s.packed.shape[1] * 4
  ev, cls, _ = replay.replay_keys(s.packed, s.nbytes, s.n_chains)
  skeys = replay.sorted_keys(ev, cls)
  sort_ms = cuda_ms(lambda: torch.sort(skeys, 1), 3)
  nb = nbytes_of(s.packed, s.nbytes, s.n_chains, s.nodes) + B * CAP * 4
  ops = (OPS_PER["replay_keys"] + OPS_PER["replay_positions"]) * B * CAP
  bms = 1e3 * max(nb / MEM_BYTES_PER_S, ops / OPS_PER_S)
  ms = stages["replay_keys"] + stages["replay_positions"]
  return (f"{h.sx}x{h.sy} replay stage at B={B}: replay_keys + "
          f"replay_positions {ms:.4f} ms against the whole stage's bound "
          f"{bms * 1e3:.2f} us ({nb} bytes, {ops} ops; {100 * bms / ms:.1f}%"
          f" of it); the int64 key sort of the sort-based design on the "
          f"same events {sort_ms:.4f} ms (not on the path)")


# wrapper name -> the names of the device kernels (csrc/, each
# f"{name}_kernel") that one launch of it may run, as a profiler trace
# lists them
DEVICE_KERNELS = {
  "replay_keys": ("replay_keys",),
  "replay_positions": ("replay_positions",),
  "paint_vcg": ("paint_vcg",),
  "ccl_paint": ("ccl_local", "ccl_merge", "ccl_count", "ccl_rank",
                "ccl_fill"),
  "ccl_min": ("ccl_local", "ccl_merge", "ccl_count", "ccl_rank"),
  "ccl_min_roots": ("ccl_local", "ccl_merge", "ccl_count", "ccl_rank"),
  "plant": ("plant_map", "plant"),
  "slice_stats": ("stats_init", "slice_stats"),
  "cancel_sums": ("cancel_sums",),
  "compact_closes": ("compact_closes",),
  "replay_positions_compact": ("replay_positions_compact",),
  "crc32c_rows": ("crc32c_chunks", "crc32c_combine"),
}
CCL_PASSES = DEVICE_KERNELS["ccl_paint"]


def ccl_pass_times(s, tile):
  """name -> {pass: device ms} of one ccl_paint (with the stream's
  table) and one ccl_min call on the full volume's VCG at
  ccl.TILE_PIX = tile, summed by kernel name from torch.profiler's
  device events; None where the profiler recorded no pass."""
  h = s.head
  ev, cls, dr = replay.replay_keys(s.packed, s.nbytes, s.n_chains)
  ids = replay.replay_positions(ev, cls, dr, s.nodes, h.sx, h.sy)
  vcg = replay.paint_vcg(ids, h.sx, h.sy, s.permissible)
  out = {}
  default = ccl.TILE_PIX
  for name, fn in (("ccl_paint", lambda: ccl.ccl_paint(vcg, s.T)),
                   ("ccl_min", lambda: ccl.ccl_min(vcg))):
    ccl.TILE_PIX = tile
    try:
      out[name] = device_ms_by_kernel(fn, CCL_PASSES) or None
    finally:
      ccl.TILE_PIX = default
  return out


def compact_stage_times(s):
  """Device ms of the compact-cancel stages of one full-volume decode,
  and of replay_positions, which they replace, on the same events."""
  h = s.head
  ev, cls, dr = replay.replay_keys(s.packed, s.nbytes, s.n_chains)
  dense = replay.cancel_sums(ev, cls, dr)
  ccap = replay.close_cap(ev.shape[1], s.nodes.shape[1])
  tables = replay.compact_closes(dense, ccap)
  return {
    "cancel_sums": cuda_ms(lambda: replay.cancel_sums(ev, cls, dr), 3),
    "compact_closes": graph_ms(lambda: replay.compact_closes(dense, ccap),
                               200),
    "replay_positions_compact": cuda_ms(
      lambda: replay.replay_positions_compact(cls, tables, s.nodes, h.sx,
                                              h.sy), 3),
    "replay_positions": cuda_ms(lambda: replay.replay_positions(
      ev, cls, dr, s.nodes, h.sx, h.sy), 3),
  }


def compact_design_line(s):
  """What the two compact kernels' designs trade, on the full volume:
  how cancel_sums' record stores coalesce (the 32-byte sectors that each
  warp step's active lanes store to in the pos plane, against one
  sector for every 8 records; the other planes take only the closes),
  cancel_sums at 16 warps a slice (2 blocks an SM) beside the default 32
  (1 block), and replay_positions_compact at other windows."""
  h = s.head
  ev, cls, dr = replay.replay_keys(s.packed, s.nbytes, s.n_chains)
  dense = replay.cancel_sums(ev, cls, dr)
  B, CAP = ev.shape
  n = (ev & 1).sum(1, keepdim=True)
  slot = torch.arange(CAP, device=ev.device).expand(B, CAP)
  at = torch.where(slot < n, dense[1].to(torch.int64), CAP)
  slot_of = torch.full((B, CAP + 1), -1, dtype=torch.int64, device=ev.device)
  slot_of.scatter_(1, at, slot)
  sec = torch.sort(slot_of[:, :CAP].reshape(B, CAP // 32, 32) // 8,
                   -1).values  # -1 where inactive
  sectors = int(((sec[..., 1:] != sec[..., :-1]) & (sec[..., 1:] >= 0)).sum()
                + (sec[..., 0] >= 0).sum())
  records = int(n.sum())
  closes = int((dense[0] >= 0).sum())
  ccap = replay.close_cap(CAP, s.nodes.shape[1])
  tables = replay.compact_closes(dense, ccap)
  warps, replay.POS_WARPS = replay.POS_WARPS, 16
  try:
    ms16 = cuda_ms(lambda: replay.cancel_sums(ev, cls, dr), 3)
  finally:
    replay.POS_WARPS = warps
  win = {}
  default = replay.COMPACT_WINDOW
  for w in (2048, 4096, 8192):
    replay.COMPACT_WINDOW = w
    try:
      win[w] = cuda_ms(lambda: replay.replay_positions_compact(
        cls, tables, s.nodes, h.sx, h.sy), 3)
    finally:
      replay.COMPACT_WINDOW = default
  return (f"cancel_sums record stores at B={B}: {sectors} sectors of 32 "
          f"bytes a plane for {records} records ({closes} closes), "
          f"{8 * sectors / records:.3f} times one sector for every 8; "
          f"cancel_sums with 16 warps a "
          f"slice {ms16:.4f} ms; replay_positions_compact ms by window "
          f"(CUDA events, mean of 3): " + ", ".join(
            f"{w} {ms:.4f}" + (" (default)" if w == default else "")
            for w, ms in win.items()))


def pins_stage_times(s):
  """Device ms of each stage of one full-volume pins decode, and of
  its CCL and paint done as v2 (ccl_min_roots, two plants) and as v1
  (ccl_paint without and with the label table); ccl_min and
  roots_from_tgt are the two steps ccl_min_roots took the place of."""
  h = s.head
  pl_, pb_, si_, sl_, bg32, cap_n = s.pins
  B = h.sz
  cap2 = ccl._pow2_cap(cap_n)
  ev, cls, dr = replay.replay_keys(s.packed, s.nbytes, s.n_chains)
  ids = replay.replay_positions(ev, cls, dr, s.nodes, h.sx, h.sy)
  vcg = replay.paint_vcg(ids, h.sx, h.sy, s.permissible)
  _, tgt = ccl.ccl_min(vcg)
  L, roots, _ = ccl.ccl_min_roots(vcg, cap2)
  cc, _ = ccl.plant(L, roots)
  Tp = torch.zeros((B, 1, cap2), dtype=torch.int32, device=s.device)
  T1 = Tp[:, :, :cap_n].contiguous()

  def table():
    return dec.pins_label_table(cc, pl_, pb_, si_, sl_, bg32, cap_n)

  def v2():
    L2, r2, _ = ccl.ccl_min_roots(vcg, cap2)
    ccl.plant(L2, r2)
    ccl.plant(L2, r2, Tp)

  def v1():
    ccl.ccl_paint(vcg)
    ccl.ccl_paint(vcg, T1)

  return {
    "replay_keys": cuda_ms(lambda: replay.replay_keys(
      s.packed, s.nbytes, s.n_chains), 3),
    "replay_positions": cuda_ms(lambda: replay.replay_positions(
      ev, cls, dr, s.nodes, h.sx, h.sy), 3),
    "paint_vcg": cuda_ms(lambda: replay.paint_vcg(
      ids, h.sx, h.sy, s.permissible), 3),
    "ccl_min": cuda_ms(lambda: ccl.ccl_min(vcg), 3),
    "roots_from_tgt": cuda_ms(lambda: ccl.roots_from_tgt(tgt, cap2), 3),
    "ccl_min_roots": cuda_ms(lambda: ccl.ccl_min_roots(vcg, cap2), 3),
    "plant K=0": cuda_ms(lambda: ccl.plant(L, roots), 3),
    "label table": cuda_ms(table, 3),
    "plant K=1": cuda_ms(lambda: ccl.plant(L, roots, Tp), 3),
    "crc32c": cuda_ms(lambda: crc32c.crc32c_rows(cc), 3),
    "v2": cuda_ms(v2, 3),
    "v1": cuda_ms(v1, 3),
  }


def union_us(spans):
  """The length of the union of sorted (start, end) intervals."""
  busy, (lo, hi) = 0, spans[0]
  for a, b in spans[1:]:
    if a > hi:
      busy, lo = busy + hi - lo, a
    hi = max(hi, b)
  return busy + hi - lo


def busy_split(fn):
  """(wall ms, device-busy ms, device events) of one fn() call: the
  union of the device-activity intervals torch.profiler records, the
  rest of the wall being host work the card waits on."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
  spans = sorted((e.time_range.start, e.time_range.end)
                 for e in prof.events() if e.device_type == DeviceType.CUDA)
  return wall_us / 1e3, (union_us(spans) / 1e3 if spans else None), \
    len(spans)


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
  busy = union_us(spans)
  return (f"512^3 device busy share over {reps} decodes: "
          f"{100 * busy / wall_us:.1f}% ({busy / 1e3:.3f} ms of device "
          f"activity in {wall_us / 1e3:.3f} ms, {len(spans)} device events)")


if __name__ == "__main__":
  if sys.argv[1:2] == ["--rank"]:
    sys.exit(rank_main(json.loads(sys.argv[2])))
  if sys.argv[1:2] == ["--trace"]:
    sys.exit(trace_main(json.loads(sys.argv[2])))
  if sys.argv[1:2] == ["--busy"]:
    sys.exit(busy_main(json.loads(sys.argv[2])))
  sys.exit(main())
