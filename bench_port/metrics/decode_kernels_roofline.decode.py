"""The decode kernels' share of their roofline: the summed bounds of
replay_keys, replay_positions, paint_vcg and ccl_paint at the window's
shapes (roofline.flat_decode_io, bound) for every traced request, over
the device time torch.profiler gives the kernels those wrappers run."""


def read(ctx):
  p, rf = ctx.path, ctx.roofline
  stream = getattr(p, "stream", None)
  if ctx.trace is None or stream is None or stream.T is None or not ctx.n:
    return None
  names = [k for w in rf.FLAT_DECODE for k in rf.DEVICE_KERNELS[w]]
  busy = ctx.trace.kernel_s(names)
  if busy <= 0:
    return None
  sx, sy, _ = p.shape
  _, K, cap_n = stream.T.shape
  io = rf.flat_decode_io(p.z1 - p.z0, stream.packed.shape[1],
                         stream.nodes.shape[1], sx, sy, K, cap_n)
  bound_ms = sum(rf.bound(w, *io[w])[2] for w in rf.FLAT_DECODE)
  return 100.0 * ctx.n * bound_ms / (busy * 1e3)
