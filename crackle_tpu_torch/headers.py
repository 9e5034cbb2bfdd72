"""Header codec for the .ckl container (reference parity: src/header.hpp,
crackle/headers.py).

Layout of the 29-byte v1 header:
  'crkl' magic (4) | version u8 | format u16 | sx,sy,sz u32 x3 |
  log2(grid_size) u8 | num_label_bytes u64 | crc8(bytes[5:28])

Format u16, LSB first:
  bits 0-1 log2(data_width), 2-3 log2(stored_width), 4 crack_format,
  5-6 label_format, 7 fortran_order, 8 signed, 9-12 markov order,
  13 NOT(is_sorted).
"""
from enum import IntEnum
from typing import Optional

import numpy as np

from .lib import (
  compute_byte_width, width2dtype, pack_bits, unpack_bits, crc8,
)

class FormatError(Exception):
  pass

class LabelFormat(IntEnum):
  FLAT = 0
  PINS_FIXED_WIDTH = 1
  PINS_VARIABLE_WIDTH = 2

class CrackFormat(IntEnum):
  IMPERMISSIBLE = 0
  PERMISSIBLE = 1

class CrackleHeader:
  MAGIC = b'crkl'
  FORMAT_VERSION = 1
  HEADER_BYTES = 29
  HEADER_BYTES_V0 = 24
  HEADER_BYTES_V1 = 29

  def __init__(
    self,
    label_format: int = LabelFormat.FLAT,
    crack_format: int = CrackFormat.IMPERMISSIBLE,
    data_width: int = 1,
    stored_data_width: int = 1,
    sx: int = 1, sy: int = 1, sz: int = 1,
    num_label_bytes: int = 0,
    fortran_order: bool = True,
    grid_size: int = 2147483648,
    signed: bool = False,
    markov_model_order: int = 0,
    is_sorted: bool = True,
    format_version: int = 1,
    crc: Optional[int] = None,
  ):
    self.label_format = label_format
    self.crack_format = crack_format
    self.data_width = int(data_width)
    self.stored_data_width = int(stored_data_width)
    self.sx = int(sx)
    self.sy = int(sy)
    self.sz = int(sz)
    self.num_label_bytes = int(num_label_bytes)
    self.fortran_order = bool(fortran_order)
    self.grid_size = int(grid_size)
    self.signed = bool(signed)
    self.markov_model_order = int(markov_model_order)
    self.is_sorted = bool(is_sorted)
    self.format_version = int(format_version)
    self.crc = crc

  @classmethod
  def frombytes(kls, buffer: bytes, ignore_crc_check: bool = False):
    buffer = bytes(buffer[:kls.HEADER_BYTES])
    if len(buffer) < kls.HEADER_BYTES:
      raise FormatError(f"Bytestream too short. Got: {buffer!r}")
    if buffer[:4] != kls.MAGIC:
      raise FormatError(
        f"Incorrect magic number. Got: {buffer[:4]!r} Expected: {kls.MAGIC!r}"
      )
    format_version = buffer[4]
    if format_version not in (0, 1):
      raise FormatError(f"Wrong format version. Got: {format_version}")

    (log_dw, log_sdw, crack_fmt, label_fmt,
     f_order, signed, markov, not_sorted) = unpack_bits(
      int.from_bytes(buffer[5:7], 'little'),
      [2, 2, 1, 2, 1, 1, 4, 1],
    )

    if format_version == 0:
      nlabel_width = 4
      stored_crc = None
    else:
      nlabel_width = 8
      stored_crc = buffer[28]
      computed_crc = crc8(buffer[5:28])
      if not ignore_crc_check and stored_crc != computed_crc:
        raise FormatError(
          f"The header appears to be corrupted. CRC check failed. "
          f"Computed: {computed_crc} Stored: {stored_crc}"
        )

    return kls(
      label_format=LabelFormat(label_fmt),
      crack_format=CrackFormat(crack_fmt),
      data_width=2 ** log_dw,
      stored_data_width=2 ** log_sdw,
      sx=int.from_bytes(buffer[7:11], 'little'),
      sy=int.from_bytes(buffer[11:15], 'little'),
      sz=int.from_bytes(buffer[15:19], 'little'),
      grid_size=2 ** int(buffer[19]),
      num_label_bytes=int.from_bytes(buffer[20:20 + nlabel_width], 'little'),
      fortran_order=bool(f_order),
      signed=bool(signed),
      markov_model_order=int(markov),
      is_sorted=not bool(not_sorted),
      format_version=format_version,
      crc=stored_crc,
    )

  def tobytes(self) -> bytes:
    fmt = pack_bits([
      (int(np.log2(self.data_width)), 2),
      (int(np.log2(self.stored_data_width)), 2),
      (int(self.crack_format), 1),
      (int(self.label_format), 2),
      (int(self.fortran_order), 1),
      (int(self.signed), 1),
      (int(self.markov_model_order), 4),
      (int(not self.is_sorted), 1),
    ])

    fmt_ver = self.format_version
    if fmt_ver == 0 and self.num_label_bytes > 0xFFFFFFFF:
      fmt_ver = 1
    nlabel_width = 4 if fmt_ver == 0 else 8

    body = b''.join([
      fmt.to_bytes(2, 'little'),
      self.sx.to_bytes(4, 'little'),
      self.sy.to_bytes(4, 'little'),
      self.sz.to_bytes(4, 'little'),
      int(np.log2(self.grid_size)).to_bytes(1, 'little'),
      self.num_label_bytes.to_bytes(nlabel_width, 'little'),
    ])

    out = self.MAGIC + fmt_ver.to_bytes(1, 'little') + body
    if fmt_ver > 0:
      out += crc8(body).to_bytes(1, 'little')
    return out

  # -- derived quantities ---------------------------------------------------

  @property
  def header_bytes(self) -> int:
    return self.HEADER_BYTES_V0 if self.format_version == 0 else self.HEADER_BYTES_V1

  @property
  def grid_index_bytes(self) -> int:
    # v1 includes a trailing crc32c over the z-index
    return 4 * self.sz if self.format_version == 0 else 4 * (self.sz + 1)

  @property
  def stored_dtype(self):
    dt = np.dtype(width2dtype[self.stored_data_width])
    if self.signed:
      dt = np.dtype(f"i{dt.itemsize}")
    return dt

  @property
  def dtype(self):
    dt = np.dtype(width2dtype[self.data_width])
    if self.signed:
      dt = np.dtype(f"i{dt.itemsize}")
    return dt

  @property
  def nbytes(self) -> int:
    return self.voxels() * self.data_width

  def voxels(self) -> int:
    return self.sx * self.sy * self.sz

  def pin_index_width(self) -> int:
    return compute_byte_width(self.sx * self.sy * self.sz)

  def index_width(self) -> int:
    return compute_byte_width(self.sx * self.sy * self.sz)

  def component_width(self) -> int:
    """Byte width of the per-grid component counts."""
    return compute_byte_width(self.sx * self.sy)

  def depth_width(self) -> int:
    return compute_byte_width(max(self.sz - 1, 0))

  def z_index_width(self) -> int:
    return 4

  def num_grids(self) -> int:
    gsize = min(self.grid_size, max(self.sx, self.sy))
    if gsize == 0:
      return self.sz
    ngrids = ((self.sx + gsize - 1) // gsize) * ((self.sy + gsize - 1) // gsize)
    ngrids = max(ngrids, 1)
    return int(ngrids * self.sz)

  @property
  def num_markov_model_bytes(self) -> int:
    """Size of the stored markov model section in bytes.

    The C++ reference rounds up ((4^k * 5) + 4) / 8 (header.hpp:284-297);
    the reference python integer-divides, which disagrees for odd k.
    The C++ is normative.
    """
    if self.markov_model_order == 0:
      return 0
    model_size = 4 ** min(self.markov_model_order, 15)
    return (model_size * 5 + 4) // 8

  def compute_crc(self) -> int:
    return self.tobytes()[-1]

  def details(self) -> str:
    label_fmt = 'FLAT'
    if self.label_format == LabelFormat.PINS_FIXED_WIDTH:
      label_fmt = 'FIXED_PINS'
    elif self.label_format == LabelFormat.PINS_VARIABLE_WIDTH:
      label_fmt = 'CONDENSED_PINS'
    crack_fmt = (
      'PERMISSIBLE' if self.crack_format == CrackFormat.PERMISSIBLE
      else 'IMPERMISSIBLE'
    )
    return f"""
    magic:         {self.MAGIC}
    version:       {self.format_version}
    label fmt:     {label_fmt}
    crack fmt:     {crack_fmt}
    data width:    {self.data_width}
    stored width:  {self.stored_data_width}
    sx:            {self.sx}
    sy:            {self.sy}
    sz:            {self.sz}
    label bytes:   {self.num_label_bytes}
    fortran order: {self.fortran_order}
    grid_size:     {self.grid_size}
    crc:           {self.crc}
    ---
    BOC width:     {self.index_width()}
    z index width: {self.z_index_width()}
    """

  def __repr__(self):
    return str(self.__dict__)
