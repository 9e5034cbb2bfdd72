"""The card's peaks and the work of each kernel, counted from shapes.

Copied from chip_smoke.py:789-856 (MEM_BYTES_PER_S, OPS_PER_S, OPS_PER,
kernel_io and bound), with the byte counts taken from the shapes of a
decode's inputs and outputs instead of from tensors, and with the CRC
gate's count from its work: the component ids read once, each slice's
stored word read once and each slice's CRC written once, whatever code
computes it.
"""

# The card's published peaks (H100 SXM data sheet): device memory, and
# the 32-bit rate outside the tensor cores, against which the kernels'
# integer operations are counted (chip_smoke.py:789-793)
MEM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12

# integer operations per element (codepoint, edge id or pixel) of each
# kernel, a floor counted from its source (chip_smoke.py:795-800)
OPS_PER = {"replay_keys": 40, "replay_positions": 30, "paint_vcg": 15,
           "ccl_paint": 20, "ccl_min": 20, "plant": 30, "slice_stats": 10,
           "cancel_sums": 50, "compact_closes": 3,
           "replay_positions_compact": 40}

# wrapper -> the device kernels one launch of it runs, as a profiler
# trace names them (f"{name}_kernel"; chip_smoke.py:3264-3276)
DEVICE_KERNELS = {
  "replay_keys": ("replay_keys",),
  "replay_positions": ("replay_positions",),
  "paint_vcg": ("paint_vcg",),
  "ccl_paint": ("ccl_local", "ccl_merge", "ccl_count", "ccl_rank",
                "ccl_fill"),
  "ccl_min": ("ccl_local", "ccl_merge", "ccl_count", "ccl_rank"),
  "plant": ("plant_map", "plant"),
  "slice_stats": ("stats_init", "slice_stats"),
  "cancel_sums": ("cancel_sums",),
  "compact_closes": ("compact_closes",),
  "replay_positions_compact": ("replay_positions_compact",),
}

# the kernels of a flat decode with its label paint (K >= 1)
FLAT_DECODE = ("replay_keys", "replay_positions", "paint_vcg", "ccl_paint")


def flat_decode_io(B: int, cap_b: int, cap_ch: int, sx: int, sy: int,
                   K: int, cap_n: int):
  """name -> (bytes, elements) of each kernel of a flat decode of B
  slices (chip_smoke.py:822-846 kernel_io): packed (B, cap_b) uint8,
  nbytes and n_chains (B,) int32, nodes (B, cap_ch) int32 and the paint
  table (B, K, cap_n) int32 in; event words and classes (B, CAP) int32,
  CAP = 4 cap_b, the depth ranges (B, 2), the edge ids (B, CAP) and the
  VCG (B, sy, sx) int32 between the kernels; each input read once and
  each output written once."""
  cap = 4 * cap_b
  npx = B * sx * sy
  packed, per_slice = B * cap_b, 2 * B * 4
  ev = cls = ids = B * cap * 4
  drange, nodes, vcg = B * 2 * 4, B * cap_ch * 4, npx * 4
  table = B * K * cap_n * 4
  return {
    "replay_keys": (packed + per_slice + ev + cls + drange, B * cap),
    "replay_positions": (ev + cls + drange + nodes + ids, B * cap),
    "paint_vcg": (ids + vcg, B * cap + npx),
    "ccl_paint": (vcg + table + npx * 4 * (1 + K) + B * 4, npx),
  }


def crc_gate_bytes(B: int, sy: int, sx: int) -> int:
  """Bytes the CRC gate of B slices must move: the (B, sy * sx) 4-byte
  component ids read once, B stored 4-byte CRC32C words read once, B
  computed 4-byte words written once."""
  return B * sy * sx * 4 + B * 4 + B * 4


def bound(name: str, nbytes: int, elems: int):
  """(bytes, ops, bound ms, "bytes" or "operations") of a kernel that
  moves nbytes over elems elements: the larger of bytes over the memory
  rate and its operations over the 32-bit rate (chip_smoke.py:849-856)."""
  ops = OPS_PER[name] * elems
  tb, to = nbytes / MEM_BYTES_PER_S, ops / OPS_PER_S
  return nbytes, ops, 1e3 * max(tb, to), "bytes" if tb >= to else \
    "operations"


def bytes_bound_ms(nbytes: int) -> float:
  """The least time in ms that moving nbytes through device memory
  takes."""
  return 1e3 * nbytes / MEM_BYTES_PER_S
