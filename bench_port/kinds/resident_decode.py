"""A stream resident on the card, decoded whole a request with the CRC
gate on; the labels stay on the card."""
from bench_port import paths
from bench_port.reference import volume


class ResidentDecode(paths.Path):
  """engine.upload_stream once in set-up; each request
  DeviceStream.decode_window(0, sz, check_crcs=True) and a sync."""

  CONTROLS = ("narrower", "narrowest")

  def setup(self):
    self.truth = self.make_volume()
    self.binary = self.make_stream(self.truth)
    self.stream = self.run.engine.upload_stream(self.binary, self.dev)
    if self.stream is None:
      raise RuntimeError("upload_stream declined the stream")
    self.z0, self.z1 = 0, self.shape[2]
    self.keep_sample(self.mix["kept"], self.mix["kept_within"])
    for _ in range(self.mix["warm"]):
      self.request(-1)

  def request(self, i):
    labels, cc, N = self.stream.decode_window(self.z0, self.z1,
                                              check_crcs=True)
    self.run.sync()
    self.cc = cc
    return labels

  def release(self):
    del self.stream, self.cc

  def check(self):
    bad = sum(volume.mismatches(lab, self.truth)
              for lab in self.kept_answers().values())
    return {"mismatched_voxels": bad}

  def control(self, name):
    """The labels stored one width narrower ("narrower") or in 8 bits
    ("narrowest") and read back."""
    bits = 8 * (self.truth.element_size() // 2 if name == "narrower" else 1)
    ans = volume.narrowed(self.truth, bits)
    self.run.sync()
    return lambda i: ans


KIND = ResidentDecode
