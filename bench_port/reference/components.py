"""Each slice's 4-connected components of a label volume, numbered in
raster first-visit order (x fastest, then y): the component ids `cc`
that every decode returns and that a stream's per-slice CRC32C words
cover. Plain PyTorch from the labels alone, independent of the program:
min-label propagation with pointer jumping, in blocks of slices so that
a 512^3 volume fits beside the program's state.
"""
import torch

# pixels of a block of slices (at least one slice): some 40 bytes a pixel
# while it runs
BLOCK_PIX = 1 << 25

_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32,
           torch.uint64: torch.int64}


def _block(labels):
  """(B, sy, sx) labels -> (cc (B, sy * sx) int32, N (B,) int32)."""
  B, sy, sx = labels.shape
  n = sy * sx
  a = labels.view(_SIGNED.get(labels.dtype, labels.dtype))
  same_x = a[:, :, 1:] == a[:, :, :-1]
  same_y = a[:, 1:] == a[:, :-1]
  ids = torch.arange(n, device=a.device).expand(B, n)
  L = ids.clone()  # each pixel's least known raster index of its component
  while True:
    L3 = L.view(B, sy, sx)
    m = L3.clone()
    m[:, :, 1:] = torch.where(same_x, torch.minimum(m[:, :, 1:],
                                                    L3[:, :, :-1]),
                              m[:, :, 1:])
    m[:, :, :-1] = torch.where(same_x, torch.minimum(m[:, :, :-1],
                                                     L3[:, :, 1:]),
                               m[:, :, :-1])
    m[:, 1:] = torch.where(same_y, torch.minimum(m[:, 1:], L3[:, :-1]),
                           m[:, 1:])
    m[:, :-1] = torch.where(same_y, torch.minimum(m[:, :-1], L3[:, 1:]),
                            m[:, :-1])
    m = m.view(B, n)
    # each pixel's index also goes to the pixel its own points at, then
    # every pointer is followed to its end
    nxt = torch.minimum(L.scatter_reduce(1, L, m, "amin"), m)
    while True:
      jumped = torch.gather(nxt, 1, nxt)
      if torch.equal(jumped, nxt):
        break
      nxt = jumped
    if torch.equal(nxt, L):
      break
    L = nxt
  # L is now each component's least raster index; its roots in raster
  # order are the first visits
  roots = L == ids
  rank = torch.cumsum(roots, 1) - 1
  return (torch.gather(rank, 1, L).to(torch.int32),
          roots.sum(1).to(torch.int32))


def components(labels):
  """labels: (sz, sy, sx) unsigned labels on any device, x fastest.
  Returns (cc (sz, sy * sx) int32, N (sz,) int32) on their device: each
  slice's component ids in first-visit order and its component count."""
  sz, sy, sx = labels.shape
  n = sy * sx
  cc = torch.empty((sz, n), dtype=torch.int32, device=labels.device)
  N = torch.zeros(sz, dtype=torch.int32, device=labels.device)
  if not n:
    return cc, N
  step = max(1, BLOCK_PIX // n)
  for z0 in range(0, sz, step):
    cc[z0:z0 + step], N[z0:z0 + step] = _block(labels[z0:z0 + step])
  return cc, N
