"""The pins decode kernels' share of their roofline: the summed bounds
of ccl_min and the two plant launches of a window at its shapes
(pins_roofline.pins_decode_bound_ms) for every traced request, over the
device time torch.profiler gives the kernels those wrappers run. Nothing
where the stream holds no pins tables or the trace no plant kernel (the
decode took its ccl_paint branch)."""
from bench_port import pins_roofline


def read(ctx):
  p = ctx.path
  pins = getattr(getattr(p, "stream", None), "pins", None)
  if ctx.trace is None or pins is None or not ctx.n:
    return None
  if ctx.trace.kernel_s(ctx.roofline.DEVICE_KERNELS["plant"]) <= 0:
    return None
  busy = ctx.trace.kernel_s(pins_roofline.PINS_KERNELS)
  sx, sy, _ = p.shape
  bound_ms = pins_roofline.pins_decode_bound_ms(p.z1 - p.z0, sx, sy, pins[5])
  return 100.0 * ctx.n * bound_ms / (busy * 1e3)
