"""File I/O: save/load with transparent .gz/.xz handling plus
extension-dispatched converters, the port's copy of crackle_tpu/util.py
(reference surface: crackle/util.py; converter formats
npy/nrrd/nii/tiff/cpso per util.py:91-233). What decodes and encodes goes
through the port's codec, so the codec's engine picks the device.

Structure here is registry-based: one `_smart_open` context manager
owns the compression wrappers, and module-level LOADERS/SAVERS tables
own the per-format dispatch, so adding a format is one table entry.
Formats whose libraries are absent raise ImportError lazily."""
import contextlib
import gzip
import io
import lzma
import mmap
import os
from typing import Optional, Union

import numpy as np

from .array import CrackleArray, CrackleRemoteArray
from .codec import compress, decompress
from .headers import CrackleHeader

_COMPRESSED_OPENERS = {
  ".gz": gzip.open,
  ".xz": lzma.open,
  ".lzma": lzma.open,
}

# extensions that identify the payload format even when a compression
# suffix follows them (x.ckl.gz -> .ckl)
_PAYLOAD_EXTS = (".ckl", ".cpso")


def normalize_file_ext(filename: str) -> str:
  """The payload extension of `filename`, looking through any chain
  of compression suffixes for a known payload type."""
  stem, ext = os.path.splitext(filename)
  seen = ext
  while ext and seen not in _PAYLOAD_EXTS:
    stem, ext = os.path.splitext(stem)
    if ext in _PAYLOAD_EXTS:
      return ext
    if ext:
      seen = ext
  return seen


@contextlib.contextmanager
def _smart_open(filelike, mode: str):
  """Yield a binary file object for a path or pass a file-like
  through; paths ending in a compression suffix get the matching
  codec wrapper. Only closes what it opened."""
  if hasattr(filelike, "read") or hasattr(filelike, "write"):
    yield filelike
    return
  opener = _COMPRESSED_OPENERS.get(
    os.path.splitext(str(filelike))[1], open)
  f = opener(filelike, mode)
  try:
    yield f
  finally:
    f.close()


def _load(filelike, size: int = -1, allow_mmap: bool = False):
  if hasattr(filelike, "read"):
    return filelike.read(size)
  is_plain = os.path.splitext(str(filelike))[1] \
    not in _COMPRESSED_OPENERS
  if allow_mmap and is_plain:
    with open(filelike, "rb") as f:
      return mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
  with _smart_open(filelike, "rb") as f:
    return f.read(size)


def load_header(filelike, **kwargs):
  """Load the header with minimal data reads."""
  binary = _load(filelike, CrackleHeader.HEADER_BYTES)
  return CrackleHeader.frombytes(binary, **kwargs)


def load_num_labels(filelike, **kwargs) -> int:
  """Read N (the unique-label count) touching only the stream prefix:
  header + grid index + the first 8-16 label bytes."""
  startpos = filelike.tell() if hasattr(filelike, "tell") else 0
  head = load_header(
    filelike, ignore_crc_check=kwargs.get("ignore_crc_check", False)
  )
  if hasattr(filelike, "seek"):
    filelike.seek(startpos)
  prefix = _load(filelike, head.header_bytes + head.grid_index_bytes + 16)
  head = CrackleHeader.frombytes(prefix)
  at = head.header_bytes + head.grid_index_bytes
  if head.label_format != 0:
    at += head.stored_data_width  # pins: bgcolor precedes N
  n = int.from_bytes(prefix[at:at + 8], "little")
  # pins exclude the background color from uniq; count it back in
  return n + (1 if head.label_format != 0 else 0)


def rload(filelike, **kwargs):
  """Load the array using a memory-efficient remote interface."""
  return CrackleRemoteArray(filelike, **kwargs)


def aload(filelike, allow_mmap=False) -> CrackleArray:
  """Load a CrackleArray from a file."""
  return CrackleArray(_load(filelike, allow_mmap=allow_mmap))


def bload(filelike, allow_mmap=False) -> bytes:
  """Load the raw binary file."""
  return _load(filelike, allow_mmap=allow_mmap)


def load(filelike, label: Optional[int] = None,
         parallel: int = 0) -> np.ndarray:
  """Load and decompress an image from a file-like or path."""
  return decompress(_load(filelike), label=label, parallel=parallel)


def load_numpy(filelike) -> np.ndarray:
  return np.load(io.BytesIO(_load(filelike)))


def _load_nrrd(filename):
  import nrrd
  image, _meta = nrrd.read(filename)
  if image.ndim == 3 and image.shape[0] == 3:
    # channel-first RGB volumes present as (3, sx, sy); expose the
    # channel axis last so downstream code sees a spatial volume
    image = np.transpose(image[..., np.newaxis], (1, 2, 3, 0))
  return image


def _load_nii(filename):
  import nibabel as nib
  return np.array(nib.load(filename).dataobj)


def _load_tiff(filename):
  import tifffile
  return tifffile.imread(filename)


def _load_cpso(filename):
  import compresso
  return compresso.load(filename)


_LOADERS = {
  ".ckl": aload,
  ".npy": load_numpy,
  ".nrrd": _load_nrrd,
  ".nii": _load_nii,
  ".tif": _load_tiff,
  ".tiff": _load_tiff,
  ".cpso": _load_cpso,
}


def load_any(filename: str) -> np.ndarray:
  loader = _LOADERS.get(normalize_file_ext(filename))
  if loader is None:
    raise ValueError(f"Data type not supported: {filename}")
  return np.asfortranarray(loader(filename))


def save_numpy(arr: Union[np.ndarray, CrackleArray, bytes], filelike,
               block_size: int = int(200e6)):
  """Write .npy. Crackle inputs stream out in decoded z-blocks of at
  most ~block_size bytes, so the full volume never materializes."""
  if isinstance(arr, np.ndarray):
    np.save(filelike, arr)
    return
  if isinstance(arr, bytes):
    arr = CrackleArray(arr)

  head = arr.header()
  sz = arr.shape[2]
  slab_bytes = max(arr.nbytes // max(sz, 1), 1)
  z_per_block = max(min(block_size // slab_bytes, sz), 1)
  order = "F" if head.fortran_order else "C"

  with _smart_open(filelike, "wb") as f:
    np.lib.format.write_array_header_2_0(f, {
      "descr": f"<u{head.data_width}",
      "fortran_order": head.fortran_order,
      "shape": arr.shape,
    })
    for z0 in range(0, sz, z_per_block):
      block = arr[:, :, z0:min(z0 + z_per_block, sz)]
      f.write(block.tobytes(order))


def _to_numpy(arr):
  if isinstance(arr, bytes):
    return decompress(arr)
  if isinstance(arr, CrackleArray):
    return arr.decompress()
  return arr


def save_nii(arr, path: str, affine=None):
  """Save as NIfTI (.nii / .nii.gz)."""
  import nibabel as nib
  if affine is None:
    affine = np.eye(4)
  nib.save(nib.Nifti1Image(_to_numpy(arr), affine), path)


def save_nrrd(arr, path: str, compress: str = "raw"):
  """Save as NRRD."""
  import nrrd
  encodings = {"gzip": "gzip", "bzip2": "bz2"}
  nrrd.write(path, _to_numpy(arr),
             {"encoding": encodings.get(compress, "raw")})


def save_tiff(arr, path: str, compression="zlib"):
  """Save as TIFF."""
  import tifffile
  tifffile.imwrite(path, _to_numpy(arr), compression=compression)


def save_compresso(arr, path: str):
  import compresso
  compresso.save(_to_numpy(arr), path)


_SAVERS = {
  ".npy": save_numpy,
  ".nrrd": save_nrrd,
  ".tif": save_tiff,
  ".tiff": save_tiff,
  ".cpso": save_compresso,
}


def save(labels: Union[np.ndarray, CrackleArray], filelike, **kwargs):
  """Save labels to a file-like or path; paths convert by extension
  (.npy/.nrrd/.tif/.cpso, with .gz/.xz wrapping for .ckl and .npy)."""
  binary = labels.binary if isinstance(labels, CrackleArray) else None

  if isinstance(filelike, str):
    saver = _SAVERS.get(normalize_file_ext(filelike))
    if saver is not None and normalize_file_ext(filelike) != ".ckl":
      return saver(binary if binary is not None else labels, filelike)

  if binary is None:
    binary = compress(labels, **kwargs)
  with _smart_open(filelike, "wb") as f:
    f.write(binary)
