"""Device ms of one CRC gate (engine.crc_gate) of the window's decode:
CUDA events around the gate on the component ids the last request's
decode_window returned, against the stream's stored words."""
REPS = 10


def read(ctx):
  p = ctx.path
  cc, stream = getattr(p, "cc", None), getattr(p, "stream", None)
  if cc is None or stream is None or stream.crcs is None:
    return None
  stored = stream.crcs[p.z0:p.z1]
  return ctx.device_ms(lambda: ctx.engine.crc_gate(cc, stored, p.z0), REPS)
