""".ckl bytes on the host in, the whole volume in host memory out,
under the engine the mix names."""
from bench_port import paths
from bench_port.reference import volume


class Decompress(paths.Path):
  """Each request codec.decompress(binary) after
  codec.set_engine(mix["engine"])."""

  CONTROLS = ("narrower", "narrowest")

  def setup(self):
    truth = self.make_volume()
    self.binary = self.make_stream(truth)
    self.truth = truth.cpu().numpy()
    del truth
    self.run.codec.set_engine(self.mix["engine"], device=self.dev)
    self.keep_sample(self.mix["kept"], self.mix["kept_within"])
    for _ in range(self.mix["warm"]):
      self.request(-1)

  def request(self, i):
    return self.run.codec.decompress(self.binary)

  def check(self):
    bad = sum(volume.mismatches_host(out, self.truth)
              for out in self.kept_answers().values())
    return {"mismatched_voxels": bad}

  def control(self, name):
    """The labels stored one width narrower ("narrower") or in 8 bits
    ("narrowest") and read back, as the (sx, sy, sz) view a decompress
    returns."""
    bits = 8 * (self.truth.itemsize // 2 if name == "narrower" else 1)
    ans = volume.narrowed(self.truth, bits).T
    return lambda i: ans


KIND = Decompress
