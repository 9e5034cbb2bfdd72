"""Build and load the port's CUDA kernels.

Counterpart of crackle_tpu/kernels/__init__.py (the JAX compile
cache). At first use, every ``crackle_tpu_torch/csrc/*.cu`` is compiled
by ``nvcc`` for ``sm_90a``, one process per source, all at once, and
linked into one shared library with a plain C interface, which is
loaded through ``ctypes``. No PyTorch header is
included, so the build takes seconds. The library lands in the
checkout's ``build/`` directory under a name that hashes the sources,
so an edited source never loads a stale build.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises when that is not 0.
"""
import ctypes
import functools
import hashlib
import os
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "crackle_tpu_torch")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

# kernel name -> launches since the last reset_launches(); each wrapper
# adds one where it launches its kernel and nowhere else
LAUNCHES = {"replay_keys": 0, "replay_positions": 0, "paint_vcg": 0,
            "ccl_paint": 0, "ccl_min": 0, "ccl_min_roots": 0, "plant": 0,
            "slice_stats": 0, "cancel_sums": 0, "compact_closes": 0,
            "replay_positions_compact": 0, "crc32c_rows": 0}

# wall seconds the last build took (0.0 when it was found built)
build_seconds = 0.0

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_SIGNATURES = {
  # packed, nbytes, n_chains, ev, cls, drange, B, CAP_B, threads,
  # aligned, stream
  "replay_keys_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
  # ev, cls, drange, nodes, scratch, ids, B, CAP, CAP_CH, sx, sy, budget,
  # stride, warps, stream
  "replay_positions_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _I, _I, _I, _P],
  # ids, vcg, B, CAP, sx, sy, permissible, band pixels, bands, V words,
  # H words, split, vec_ids, stream
  "paint_vcg_launch": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                       _P],
  # vcg, T, L, counts, cc, N, painted, B, sx, sy, K, cap_n, tile, stream
  "ccl_paint_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       _P],
  # vcg, L, counts, tgt, B, sx, sy, tile, stream
  "ccl_min_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
  # vcg, L, counts, roots, N, B, sx, sy, cap, tile, stream
  "ccl_min_roots_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
  # L, roots, T, map, cc, painted, B, n, K, cap_n, span, vec, stream
  "plant_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
  # cc, out, B, sx, sy, cap_n, band_rows, stream
  "slice_stats_launch": [_P, _P, _I, _I, _I, _I, _I, _P],
  # ev, cls, drange, scratch, dense, B, CAP, budget, stride, warps,
  # stream
  "cancel_sums_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
  # dense, tables, scratch, B, CAP, CCAP, stream
  "compact_closes_launch": [_P, _P, _P, _I, _I, _I, _P],
  # cls, tables, nodes, state, ids, B, CAP, CCAP, CAP_CH, sx, sy,
  # window, stream
  "replay_positions_compact_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                      _I, _I, _I, _P],
  # words, tables, ctab, part, stored, crc, first_bad, B, W, nchunks, G,
  # vec, c0, stream
  "crc32c_rows_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _U,
                         _P],
}


def reset_launches():
  for k in LAUNCHES:
    LAUNCHES[k] = 0


def _sources():
  return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                if f.endswith((".cu", ".cuh")))


def _nvcc():
  home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
  path = os.path.join(home, "bin", "nvcc")
  return path if os.path.exists(path) else "nvcc"


@functools.lru_cache(maxsize=1)
def library():
  """The loaded kernel library, compiled first if needed."""
  global build_seconds
  srcs = _sources()
  h = hashlib.sha256()
  for s in srcs:
    with open(s, "rb") as f:
      h.update(os.path.basename(s).encode() + b"\0" + f.read())
  so = os.path.join(BUILD_DIR, f"libcrackle_kernels_{h.hexdigest()[:16]}.so")
  if not os.path.exists(so):
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    objs, jobs = [], []
    for src in (s for s in srcs if s.endswith(".cu")):
      obj = f"{tmp}.{os.path.basename(src)}.o"
      cmd = [_nvcc()] + NVCC_FLAGS + ["-I", CSRC, "-c", "-o", obj, src]
      objs.append(obj)
      jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.PIPE, text=True)))
    for cmd, proc in jobs:
      _, err = proc.communicate()
      if proc.returncode != 0:
        for _, other in jobs:
          other.kill()
          other.wait()
        raise RuntimeError(
          f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
    cmd = [_nvcc(), "-shared", "-o", tmp] + objs
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
      raise RuntimeError(
        f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{res.stderr}")
    build_seconds = time.perf_counter() - t0
    os.replace(tmp, so)
    for obj in objs:
      os.remove(obj)
  lib = ctypes.CDLL(so)
  for name, argtypes in _SIGNATURES.items():
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
  return lib


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
  import torch
  return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
  """Streaming multiprocessors of a CUDA device (the grids' fill)."""
  import torch
  d = torch.device(device)
  return _sms(d.index if d.index is not None else
              torch.cuda.current_device())


def check(name: str, err: int):
  if err != 0:
    raise RuntimeError(f"{name}: CUDA error {err} at launch")
