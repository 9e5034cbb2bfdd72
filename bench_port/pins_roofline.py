"""The work of the kernels of a condensed-pins window's CCL and paint
(crackle_tpu_torch/kernels/decode.py pins_labels_from_vcg): ccl_min,
then plant with no table (K = 0) for the first-visit ids, then plant
with the label table (K = 1), counted from the window's shapes as
roofline.flat_decode_io counts the flat decode's, each input read once
and each output written once (chip_smoke.py kernel_io's ccl_min and
plant). The bounds come from roofline.bound and OPS_PER.
"""
from . import roofline

# (launch, the wrapper whose operation count it takes)
PINS_DECODE = (("ccl_min", "ccl_min"), ("plant_k0", "plant"),
               ("plant_k1", "plant"))

# the device kernels those wrappers run, as a trace names them
PINS_KERNELS = roofline.DEVICE_KERNELS["ccl_min"] + \
  roofline.DEVICE_KERNELS["plant"]


def roots_width(cap_n: int) -> int:
  """Entries of a slice's sorted roots and of the plant's table: the
  power of two at or above the stream's cap_n, at least 8 (the decode's
  _pow2_cap)."""
  return max(8, 1 << max(int(cap_n) - 1, 0).bit_length())


def pins_decode_io(B: int, sx: int, sy: int, cap_n: int):
  """launch -> (bytes, elements) of each kernel launch of a pins window
  of B slices: the VCG (B, sy, sx) int32 in and the min-index image L
  and the roots' ranks tgt (B, sy * sx) int32 out of ccl_min; L and the
  roots (B, cap2) int32 in and cc (B, sy * sx) int32 out of the first
  plant; those, the label table (B, 1, cap2) int32 in and the painted
  labels (B, sy * sx) int32 out of the second. cap2 = roots_width."""
  npx = B * sx * sy
  cap2 = roots_width(cap_n)
  img = npx * 4
  roots = table = B * cap2 * 4
  return {
    "ccl_min": (img + 2 * img, npx),
    "plant_k0": (img + roots + img, npx),
    "plant_k1": (img + roots + table + 2 * img, npx),
  }


def pins_decode_bound_ms(B: int, sx: int, sy: int, cap_n: int) -> float:
  """The least time the three launches take, summed."""
  io = pins_decode_io(B, sx, sy, cap_n)
  return sum(roofline.bound(w, *io[k])[2] for k, w in PINS_DECODE)
