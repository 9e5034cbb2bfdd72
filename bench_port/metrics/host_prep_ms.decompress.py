"""Host ms of the host prep of the whole volume: the host clock around
engine.prepare_slice_inputs(binary, 0, sz), the mean of REPS calls."""
REPS = 5


def read(ctx):
  p = ctx.path
  binary = getattr(p, "binary", None)
  if binary is None:
    return None
  sz = p.shape[2]
  return ctx.host_ms(lambda: ctx.engine.prepare_slice_inputs(binary, 0, sz),
                     REPS)
