"""crackle_tpu_torch: the crackle decode path on a torch device.

A port of crackle_tpu's device-resident decode to PyTorch, with
hand-written CUDA kernels for Hopper (sm_90a) in csrc/. It reuses the
reference's host layer (crackle_tpu.headers, lib, codec, ops, models,
native), none of which imports JAX, and never imports JAX itself.

  stream = upload_stream(binary, torch.device("cuda"))
  labels, cc, N = stream.decode_window(0, stream.head.sz, check_crcs=True)

On a CUDA tensor each kernel wrapper launches its kernel (or raises);
on a CPU tensor it runs the kernel's plain PyTorch version.
"""
from .kernels._build import LAUNCHES, reset_launches
from .kernels.ccl import ccl_paint
from .kernels.decode import decode_slices_full_plant, decode_slices_to_ccl
from .kernels.engine import (
  CrackFormat, DeviceStream, FormatError, decode_window_ccl_device,
  params_from_jax, prepare_slice_inputs, upload_stream,
)
from .kernels.replay import paint_vcg, replay_keys, replay_positions

__all__ = [
  "LAUNCHES", "reset_launches", "ccl_paint", "decode_slices_full_plant",
  "decode_slices_to_ccl", "CrackFormat", "DeviceStream", "FormatError",
  "decode_window_ccl_device", "params_from_jax", "prepare_slice_inputs",
  "upload_stream", "paint_vcg", "replay_keys", "replay_positions",
]
