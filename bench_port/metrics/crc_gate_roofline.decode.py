"""The CRC gate's share of its roofline: the least time its bytes take
(roofline.crc_gate_bytes, counted from the work) over its measured time,
the reading of crc_gate_ms.decode."""


def read(ctx):
  ms = ctx.metric("crc_gate_ms.decode")
  if not ms:
    return None
  p = ctx.path
  sx, sy, _ = p.shape
  bound = ctx.roofline.bytes_bound_ms(
    ctx.roofline.crc_gate_bytes(p.z1 - p.z0, sy, sx))
  return 100.0 * bound / ms
