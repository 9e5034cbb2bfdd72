"""crackle_tpu_torch: the crackle decode and encode paths on a torch device.

A port of crackle_tpu's device-resident decode and device encode to
PyTorch, with hand-written CUDA kernels for Hopper (sm_90a) in csrc/.
It carries its own copy of the reference's host layer (headers, lib,
codec, ops, models, native: the numpy and native host engine) and its
stream operations and analytics, and imports nothing of crackle_tpu and
nothing of JAX.

  stream = upload_stream(binary, torch.device("cuda"))  # flat or pins
  labels, cc, N = stream.decode_window(0, stream.head.sz, check_crcs=True)

  vol = decode_window(binary, 0, 64)          # host numpy, decoded on the card
  mask = decode_window(binary, 0, 64, label=7)
  set_engine("torch")                         # codec.decompress on the card
  binary = codec.compress(labels_tensor)      # encode stages on its device

  arr = CrackleDeviceArray(binary, "cuda")
  cutout = arr[100:300, 50:450, 200:264]  # a uint32/uint64 CUDA tensor
  counts = arr.voxel_counts()             # stats kernel on the card

  binary = remap(binary, {1: 2})          # edits of the stream's bytes
  vcg = voxel_connectivity_graph(binary)  # replay kernels on the card
  areas = contacts(binary, (4, 4, 40))    # labels decoded on the card

  arr = CrackleArray(binary)              # the stream in host memory
  cutout = arr[100:300, 50:450, 200:264]  # host numpy, through the codec
  arr[:, :, 200:264] = 0                  # an edit, encoded through it
  slab = rload("vol.ckl")[7]              # one slice read by byte ranges
  save(arr, "vol.ckl.gz"); arr = aload("vol.ckl.gz")

The host arrays (CrackleArray, CrackleRemoteArray), util's save and load
and the command line (crackle_tpu_torch.cli, installed as crackle-torch)
decode and encode through the codec too; their statistics run on the
codec engine's device. The command line takes the torch engine on the
card where one is present and the engine is 'auto'.

The stream operations (remap, mask, zsplit, full, the scalar operators,
...) are host byte surgery, as in the reference; what decodes
(voxel_connectivity_graph, contacts, structure_equal, array_equal, each,
mode_pooling_2x2x1, connected_components, recompress) goes through the
codec's engine, so set_engine('torch') sends it to the card ('auto'
with a card sends pins, markov and label= windows there and decodes flat
ones with the native host decoder first), and set_engine('torch',
device="cpu") to the plain versions.

On a CUDA tensor each kernel wrapper launches its kernel (or raises);
on a CPU tensor it runs the kernel's plain PyTorch version.
"""
from .array import CrackleArray, CrackleDeviceArray, CrackleRemoteArray
from .codec import (
  compress, compressa, decompress, labels, labels_for_z_range,
  nbytes, components, component_lengths,
  header, contains, contains_range, crack_codes, num_labels,
  reencode, condense_unique, ok, check,
  raw_labels, background_color, decode_pins,
  get_engine, set_engine,
)
from .headers import CrackleHeader
from .kernels._build import LAUNCHES, reset_launches
from .kernels.ccl import (
  ccl_min, ccl_paint, ccl_paint_v2, plant, roots_from_tgt,
)
from .kernels.decode import (
  decode_slices_full, decode_slices_full_pins, decode_slices_full_plant,
  decode_slices_to_ccl,
)
from .kernels.engine import (
  CrackFormat, DeviceStream, FormatError, decode_window, decode_window_ccl,
  decode_window_ccl_device, decode_window_device,
  decode_window_labels_device, decode_window_vcg_device, params_from_jax,
  prepare_slice_inputs, prepare_split_inputs, upload_stream,
)
from .kernels.replay import paint_vcg, replay_keys, replay_positions
from .kernels.stats import slice_stats
from .ops.analytics import (
  bounding_boxes, cache_meta, centroids, each, point_cloud, voxel_counts,
)
from .operations import (
  astype, ascontiguousarray, asfortranarray,
  remap, refit, renumber,
  min, max,
  zstack, zsplit, zshatter,
  full, zeros, ones,
  add_scalar, subtract_scalar,
  multiply_scalar, floordiv_scalar,
  recompress, connected_components,
  mask, mask_except,
  voxel_connectivity_graph,
  contacts,
  array_equal, structure_equal,
  mode_pooling_2x2x1,
)
from .util import save, load, aload, bload, rload, save_numpy

__version__ = "0.1.0"

__all__ = [
  "CrackleArray", "CrackleDeviceArray", "CrackleRemoteArray",
  "compress", "compressa", "decompress", "labels", "labels_for_z_range",
  "nbytes", "components", "component_lengths", "header", "contains",
  "contains_range", "crack_codes", "num_labels", "reencode",
  "condense_unique", "ok", "check", "raw_labels", "background_color",
  "decode_pins", "CrackleHeader", "save", "load", "aload", "bload",
  "rload", "save_numpy", "__version__",
  "get_engine", "set_engine", "LAUNCHES",
  "reset_launches", "ccl_min", "ccl_paint", "ccl_paint_v2", "plant",
  "roots_from_tgt", "decode_slices_full", "decode_slices_full_pins",
  "decode_slices_full_plant", "decode_slices_to_ccl", "CrackFormat",
  "DeviceStream", "FormatError", "decode_window", "decode_window_ccl",
  "decode_window_ccl_device", "decode_window_device",
  "decode_window_labels_device", "decode_window_vcg_device",
  "params_from_jax", "prepare_slice_inputs", "prepare_split_inputs",
  "upload_stream", "paint_vcg", "replay_keys", "replay_positions",
  "slice_stats", "bounding_boxes", "cache_meta", "centroids", "each",
  "point_cloud", "voxel_counts",
  "astype", "ascontiguousarray", "asfortranarray", "remap", "refit",
  "renumber", "min", "max", "zstack", "zsplit", "zshatter", "full",
  "zeros", "ones", "add_scalar", "subtract_scalar", "multiply_scalar",
  "floordiv_scalar", "recompress", "connected_components", "mask",
  "mask_except", "voxel_connectivity_graph", "contacts", "array_equal",
  "structure_equal", "mode_pooling_2x2x1",
]
