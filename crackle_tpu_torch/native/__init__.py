"""Native host library loader.

The port's copy of crackle_tpu/native. Builds (once, on demand) into
the checkout's build/crackle_tpu_torch/ and loads crackle_native.so via
ctypes. All
users fall back to the pure numpy paths when the toolchain is absent,
so the native library is a transparent accelerator for the host-side
serial hot loops (encode trace, raster CCL, markov bitstream, VCG
replay)."""
import ctypes
import os
import subprocess
import sys
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "crackle_native.cpp")
_BUILD = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                      "crackle_tpu_torch")
_LIB = os.path.join(_BUILD, "crackle_native.so")

_lib = None
_tried = False
# load() runs from the encode's trace threads too: one thread builds and
# loads, the others wait for it rather than see None
_lock = threading.Lock()


def _build() -> bool:
  # processes that build at once each write their own file, and the
  # rename makes the library appear whole
  tmp = f"{_LIB}.{os.getpid()}.tmp"
  try:
    os.makedirs(_BUILD, exist_ok=True)
    cmd = [
      "g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
      _SRC, "-o", tmp,
    ]
    res = subprocess.run(cmd, capture_output=True, timeout=120)
    if res.returncode != 0:
      return False
    os.replace(tmp, _LIB)
    return True
  except Exception:
    return False


def load():
  """Load (building if needed) the native library; None if
  unavailable."""
  if _lib is not None:
    return _lib
  with _lock:
    return _lib if _tried else _load()


def _load():
  global _lib, _tried
  _tried = True
  if not os.path.exists(_LIB) or (
    os.path.exists(_SRC)
    and os.path.getmtime(_SRC) > os.path.getmtime(_LIB)
  ):
    if not _build():
      return None
  try:
    lib = ctypes.CDLL(_LIB)
  except OSError:
    return None

  i64 = ctypes.c_int64
  i32 = ctypes.c_int32
  p = ctypes.c_void_p

  lib.crackle_trace_slice.restype = i64
  lib.crackle_trace_slice.argtypes = [
    p, i32, i64, i64, i32, p, p, i64, p, i64, p, p, i64,
  ]
  lib.crackle_encode_slice.restype = i64
  lib.crackle_encode_slice.argtypes = [
    p, i32, i64, i64, i32, p, p, i64, p, i64, p, p, i64,
    p, i64, p, p, p,
  ]
  lib.crackle_encode_slice_vcg.restype = i64
  lib.crackle_encode_slice_vcg.argtypes = [
    p, i64, i64, i32, p, p, i64, p, i64, p, p, i64, p, i64,
  ]
  lib.crackle_ccl_slice.restype = i64
  lib.crackle_ccl_slice.argtypes = [p, i32, i64, i64, p]
  lib.crackle_ccl_vcg_slice.restype = i64
  lib.crackle_ccl_vcg_slice.argtypes = [p, i64, i64, p]
  lib.crackle_replay_vcg.restype = i64
  lib.crackle_replay_vcg.argtypes = [p, i64, p, i64, i64, i64, i32, p]
  lib.crackle_markov_decode.restype = i64
  lib.crackle_markov_decode.argtypes = [p, i64, p, i64, p, i64]
  lib.crackle_markov_encode.restype = i64
  lib.crackle_markov_encode.argtypes = [p, i64, p, i64, p, i64]
  lib.crackle_decompress_stream.restype = i64
  lib.crackle_decompress_stream.argtypes = [p, i64, i64, i64, p, i64]
  lib.crackle_compress_stream.restype = i64
  lib.crackle_compress_stream.argtypes = [
    p, i32, i64, i64, i64, i32, p, i64,
  ]
  lib.crackle_crc32c.restype = ctypes.c_uint32
  lib.crackle_crc32c.argtypes = [p, i64]
  lib.crackle_pins_pick.restype = i64
  lib.crackle_pins_pick.argtypes = [p, p, i64, p, p, p, p, p]

  _lib = lib
  return _lib


def available() -> bool:
  return load() is not None


def _ptr(arr: np.ndarray):
  return arr.ctypes.data_as(ctypes.c_void_p)


# per-thread: encode slices run on a thread pool, and concurrent
# traces must not share buffers
import threading as _threading

_trace_scratch_tls = _threading.local()


def trace_slice(labels_flat: np.ndarray, sx: int, sy: int,
                permissible: bool):
  """C++ crack trace of one slice. Returns (nodes, cp_lens,
  codepoints) in discovery order, or None if unavailable."""
  lib = load()
  if lib is None:
    return None
  labels_flat = np.ascontiguousarray(labels_flat)
  width = labels_flat.dtype.itemsize
  n_corners = (sx + 1) * (sy + 1)
  sym_cap = max(16 * sx * sy + 64, 4096)
  cps_cap = sym_cap * 2
  max_chains = sx * sy + 8

  # scratch buffers are reused across slices (the C side initializes
  # what it reads); one set per thread
  scratch = getattr(_trace_scratch_tls, 'bufs', None)
  if scratch is None:
    scratch = _trace_scratch_tls.bufs = {}
  key = (sx, sy)
  bufs = scratch.get(key)
  if bufs is None:
    bufs = (
      np.zeros(n_corners, np.uint8),
      np.zeros(sym_cap, np.uint8),
      np.zeros(cps_cap, np.uint8),
      np.zeros(max_chains, np.int64),
      np.zeros(max_chains, np.int64),
    )
    scratch[key] = bufs
  adj, symbols, cps, nodes, cp_lens = bufs

  n_chains = lib.crackle_trace_slice(
    _ptr(labels_flat), width, sx, sy, int(permissible),
    _ptr(adj), _ptr(symbols), sym_cap,
    _ptr(cps), cps_cap, _ptr(nodes), _ptr(cp_lens), max_chains,
  )
  if n_chains < 0:
    return None  # overflow: caller falls back to python
  total = int(cp_lens[:n_chains].sum())
  return (nodes[:n_chains].copy(), cp_lens[:n_chains].copy(),
          cps[:total].copy())


def encode_slice(labels_flat: np.ndarray, sx: int, sy: int,
                 permissible: bool):
  """Fused C++ per-slice FLAT encode: packed crack code (BOC index +
  diff-packed moves), first-visit CCL image, per-component source
  labels. Returns (code bytes, cc uint32 view, mapping, n) or None.

  The cc view aliases a per-thread scratch buffer — consume it (crc)
  before the next call on the same thread."""
  lib = load()
  if lib is None:
    return None
  labels_flat = np.ascontiguousarray(labels_flat)
  width = labels_flat.dtype.itemsize
  n_corners = (sx + 1) * (sy + 1)
  sxy = sx * sy
  sym_cap = max(16 * sxy + 64, 4096)
  cps_cap = sym_cap * 2
  max_chains = sxy + 8
  code_cap = cps_cap // 4 + 16 * max_chains + 64

  scratch = getattr(_trace_scratch_tls, 'enc_bufs', None)
  if scratch is None:
    scratch = _trace_scratch_tls.enc_bufs = {}
  key = (sx, sy)
  bufs = scratch.get(key)
  if bufs is None:
    bufs = (
      np.zeros(n_corners, np.uint8),     # adj
      np.zeros(sym_cap, np.uint8),       # symbols
      np.zeros(cps_cap, np.uint8),       # cps
      np.zeros(max_chains, np.int64),    # nodes
      np.zeros(max_chains, np.int64),    # cp lens
      np.zeros(code_cap, np.uint8),      # packed code
      np.zeros(sxy, np.uint32),          # cc image
      np.zeros(sxy, np.uint64),          # mapping
    )
    scratch[key] = bufs
  adj, symbols, cps, nodes, cp_lens, code, cc, mapping = bufs
  out_n = np.zeros(1, np.int64)

  code_len = lib.crackle_encode_slice(
    _ptr(labels_flat), width, sx, sy, int(permissible),
    _ptr(adj), _ptr(symbols), sym_cap, _ptr(cps), cps_cap,
    _ptr(nodes), _ptr(cp_lens), max_chains,
    _ptr(code), code_cap, _ptr(cc), _ptr(mapping), _ptr(out_n),
  )
  if code_len < 0:
    return None
  n = int(out_n[0])
  return code[:code_len].tobytes(), cc, mapping[:n].copy(), n


def encode_slice_vcg(vcg_flat: np.ndarray, sx: int, sy: int,
                     permissible: bool):
  """Host tail of the device encode: packed crack code bytes for one
  slice from a device-computed 4-bit VCG (bits +x,-x,+y,-y passable).
  Returns bytes or None (unavailable / overflow)."""
  lib = load()
  if lib is None:
    return None
  vcg_flat = np.ascontiguousarray(vcg_flat, dtype=np.uint8)
  n_corners = (sx + 1) * (sy + 1)
  sxy = sx * sy
  sym_cap = max(16 * sxy + 64, 4096)
  cps_cap = sym_cap * 2
  max_chains = sxy + 8
  code_cap = cps_cap // 4 + 16 * max_chains + 64

  scratch = getattr(_trace_scratch_tls, 'encv_bufs', None)
  if scratch is None:
    scratch = _trace_scratch_tls.encv_bufs = {}
  key = (sx, sy)
  bufs = scratch.get(key)
  if bufs is None:
    bufs = (
      np.zeros(n_corners, np.uint8),     # adj
      np.zeros(sym_cap, np.uint8),       # symbols
      np.zeros(cps_cap, np.uint8),       # cps
      np.zeros(max_chains, np.int64),    # nodes
      np.zeros(max_chains, np.int64),    # cp lens
      np.zeros(code_cap, np.uint8),      # packed code
    )
    scratch[key] = bufs
  adj, symbols, cps, nodes, cp_lens, code = bufs

  code_len = lib.crackle_encode_slice_vcg(
    _ptr(vcg_flat), sx, sy, int(permissible),
    _ptr(adj), _ptr(symbols), sym_cap, _ptr(cps), cps_cap,
    _ptr(nodes), _ptr(cp_lens), max_chains,
    _ptr(code), code_cap,
  )
  if code_len < 0:
    return None
  return code[:code_len].tobytes()


def ccl_slice(labels_flat: np.ndarray, sx: int, sy: int):
  """C++ union-find CCL. Returns (cc uint32, N) or None."""
  lib = load()
  if lib is None:
    return None
  labels_flat = np.ascontiguousarray(labels_flat)
  out = np.zeros(sx * sy, np.uint32)
  n = lib.crackle_ccl_slice(
    _ptr(labels_flat), labels_flat.dtype.itemsize, sx, sy, _ptr(out)
  )
  if n < 0:
    return None
  return out, int(n)


def ccl_vcg_slice(vcg: np.ndarray, sx: int, sy: int):
  lib = load()
  if lib is None:
    return None
  vcg = np.ascontiguousarray(vcg, dtype=np.uint8)
  out = np.zeros(sx * sy, np.uint32)
  n = lib.crackle_ccl_vcg_slice(_ptr(vcg), sx, sy, _ptr(out))
  if n < 0:
    return None
  return out, int(n)


def replay_vcg(cps: np.ndarray, nodes: np.ndarray, sx: int, sy: int,
               permissible: bool):
  lib = load()
  if lib is None:
    return None
  cps = np.ascontiguousarray(cps, dtype=np.uint8)
  nodes = np.ascontiguousarray(nodes, dtype=np.int64)
  base = 0 if permissible else 0b1111
  edges = np.full(sx * sy, base, np.uint8)
  rc = lib.crackle_replay_vcg(
    _ptr(cps), len(cps), _ptr(nodes), len(nodes), sx, sy,
    int(permissible), _ptr(edges),
  )
  if rc < 0:
    raise ValueError("crackle: decode_crack_code: index out of range.")
  return edges


def markov_decode(stream: bytes, model_inv: np.ndarray, order: int,
                  out_cap: int):
  lib = load()
  if lib is None:
    return None
  s = np.frombuffer(stream, np.uint8)
  model_inv = np.ascontiguousarray(model_inv, dtype=np.uint8)
  out = np.zeros(out_cap, np.uint8)
  n = lib.crackle_markov_decode(
    _ptr(s), len(s), _ptr(model_inv), order, _ptr(out), out_cap
  )
  return out[:n]


def markov_encode(diffs: np.ndarray, model: np.ndarray, order: int):
  lib = load()
  if lib is None:
    return None
  diffs = np.ascontiguousarray(diffs, dtype=np.uint8)
  model = np.ascontiguousarray(model, dtype=np.uint8)
  cap = (2 + 3 * max(len(diffs), 1) + 7) // 8 + 8
  out = np.zeros(cap, np.uint8)
  n = lib.crackle_markov_encode(
    _ptr(diffs), len(diffs), _ptr(model), order, _ptr(out), cap
  )
  if n < 0:
    return None
  return out[:n].tobytes()


def decompress_stream(binary: bytes, z_start: int, z_end: int,
                      shape, data_width: int, fortran_order: bool):
  """Full native decode of a flat-label stream z-window. Returns the
  (sx, sy, szr) array or None (unsupported stream / lib missing).
  Raises ValueError on crc mismatch."""
  lib = load()
  if lib is None:
    return None
  sx, sy, sz = shape
  szr = z_end - z_start
  dtype = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[data_width]
  order = 'F' if fortran_order else 'C'
  out = np.empty((sx, sy, szr), dtype=dtype, order=order)
  buf = np.frombuffer(binary, np.uint8)
  rc = lib.crackle_decompress_stream(
    _ptr(buf), len(binary), z_start, z_end,
    out.ctypes.data_as(ctypes.c_void_p), out.nbytes,
  )
  if rc == 0:
    return out
  if rc == -4:
    raise ValueError("crackle: crc mismatch during native decode")
  return None


def compress_stream(flat: np.ndarray, sx: int, sy: int, sz: int,
                    fortran_order: bool = True):
  """Fully-native FLAT compress of an F-order flat label array (the
  wasm port's encode entry; byte-identical to codec.compress for
  flat non-markov streams). Returns bytes or None."""
  lib = load()
  if lib is None:
    return None
  flat = np.ascontiguousarray(flat)
  cap = int(flat.nbytes * 2 + 64 * (sz + 1) + 4096)
  out = np.zeros(cap, np.uint8)
  n = lib.crackle_compress_stream(
    _ptr(flat), flat.dtype.itemsize, sx, sy, sz,
    int(fortran_order), _ptr(out), cap,
  )
  if n < 0:
    return None
  return out[:n].tobytes()


def crc32c(data: bytes):
  """Standard CRC-32C of data, or None if the library is missing."""
  lib = load()
  if lib is None:
    return None
  return int(lib.crackle_crc32c(data, len(data)))


def pins_pick(uni: np.ndarray, uoff: np.ndarray, choice: np.ndarray,
              coff: np.ndarray, cids: np.ndarray):
  """The fast pin solver's picks in C++ (ops/pins.py pick): returns
  (picks int32, per-label counts int64), or None if the library is
  missing. Raises OverflowError where a label's hash set overflows, as
  rh_set.py does, and ValueError on a choice that does not cross its
  component."""
  lib = load()
  if lib is None:
    return None
  uni = np.ascontiguousarray(uni, np.uint32)
  uoff = np.ascontiguousarray(uoff, np.int64)
  choice = np.ascontiguousarray(choice, np.int32)
  coff = np.ascontiguousarray(coff, np.int64)
  cids = np.ascontiguousarray(cids, np.uint32)
  nlab = len(uoff) - 1
  if nlab < 0 or uoff[0] != 0 or uoff[-1] != len(uni) or \
     coff[-1] != len(cids) or (len(uni) and int(uni.max()) >= len(choice)) \
     or (len(choice) and int(choice.max()) >= len(coff) - 1):
    raise ValueError("pins_pick: inconsistent tables")
  picks = np.zeros(max(len(uni), 1), np.int32)
  npicks = np.zeros(max(nlab, 1), np.int64)
  n = lib.crackle_pins_pick(_ptr(uni), _ptr(uoff), nlab, _ptr(choice),
                            _ptr(coff), _ptr(cids), _ptr(picks),
                            _ptr(npicks))
  if n == -1:
    raise OverflowError("robin_hood emulation: table overflow")
  if n < 0:
    raise ValueError("pins_pick: a pin does not cross its component")
  return picks[:n], npicks[:nlab]
