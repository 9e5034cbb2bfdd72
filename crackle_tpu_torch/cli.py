"""Command line interface, the port's copy of crackle_tpu/cli.py
(reference parity: crackle_cli/cli.py).

crackle-torch [OPTIONS] FILES... (or python -m crackle_tpu_torch.cli):
compress/decompress/convert between .ckl and npy/nrrd/tiff/cpso, print
header info, run corruption checks, markov reencode, parquet sidecar
generation. Decodes and encodes go through the port's codec. A command
runs on the codec's torch engine on the card where one is present and
the engine was left at 'auto' (which sends flat decodes and numpy
encodes to the host), so every decode and the flat encode run there;
an engine the caller set is kept.
"""
import contextlib
import os
import sys

import click
import numpy as np
import torch

from . import compress as _compress, decompress, bload, num_labels
from . import codec, util
from .ops import analytics


class Tuple3(click.Tuple):
  def __init__(self):
    super().__init__([int, int, int])


@click.command()
@click.option('-d', '--decompress', "do_decompress", is_flag=True,
              default=False, help="Decompress a .ckl file to .npy")
@click.option('-i', '--info', is_flag=True, default=False,
              help="Print the header of a .ckl file.")
@click.option('-l', '--labels', "print_labels", is_flag=True,
              default=False, help="Print the unique labels.")
@click.option('-T', '--test', "run_test", is_flag=True, default=False,
              help="Check the file for corruption.")
@click.option('-p', '--pins', is_flag=True, default=False,
              help="Enable pin encoding (fast solver).")
@click.option('-P', '--optimal-pins', is_flag=True, default=False,
              help="Enable pin encoding (optimizing solver).")
@click.option('-m', '--markov', default=0,
              help="Markov model order for crack codes. 0 disables.")
@click.option('-k', '--keep', is_flag=True, default=False,
              help="Keep the original file.")
@click.option('-z', '--z-range', default=None, type=str,
              help="Decode only z slices START:END (e.g. 3:7).")
@click.option('-M', '--meta', is_flag=True, default=False,
              help="Write a parquet metadata sidecar (.ckl.meta).")
@click.option('-S', '--shape', default=None, type=str,
              help="Shape sx,sy,sz for raw inputs.")
@click.option('-t', '--dtype', default=None, type=str,
              help="Dtype for raw inputs (e.g. uint32).")
@click.argument("source", nargs=-1)
def main(do_decompress, info, print_labels, run_test, pins, optimal_pins,
         markov, keep, z_range, meta, shape, dtype, source):
  """Compress and decompress crackle (.ckl) files.

  Examples: crackle image.npy          -> image.ckl

            crackle -d image.ckl       -> image.npy

            crackle -i image.ckl       -> print header

            crackle -m 5 image.ckl     -> reencode with markov order 5
  """
  with card_engine():
    for src in source:
      if info:
        print_header(src)
      elif print_labels:
        do_print_labels(src)
      elif run_test:
        check_file(src)
      elif meta:
        write_meta(src)
      elif do_decompress:
        decompress_file(src, keep, z_range)
      else:
        compress_file(src, keep, pins, optimal_pins, markov)


@contextlib.contextmanager
def card_engine():
  """The codec's torch engine on the card for one command, where a card
  is present and the engine is 'auto'; the engine as it was after."""
  engine, device = codec.get_engine(), codec._DEVICE
  if engine == 'auto' and torch.cuda.is_available():
    codec.set_engine('torch')
  try:
    yield
  finally:
    codec.set_engine(engine, device=device)


def print_header(src):
  head = util.load_header(src)
  print(f"{src}:")
  print(head.details())
  try:
    binary = bload(src)
    print(f"    num labels:    {num_labels(binary)}")
    print(f"    compressed:    {len(binary)} bytes")
    print(f"    raw:           {head.nbytes} bytes")
    if head.nbytes:
      print(f"    ratio:         {len(binary) / head.nbytes:.4%}")
  except Exception:
    pass


def do_print_labels(src):
  binary = bload(src)
  for label in codec.labels(binary):
    print(label)


def check_file(src):
  binary = bload(src)
  report = codec.check(binary)
  ok = codec.ok(binary)
  print(f"{src}: {'OK' if ok else 'CORRUPTED'}")
  if not ok:
    for section, status in report.items():
      if status is False:
        print(f"  {section}: DAMAGED")
      elif isinstance(status, list) and status:
        print(f"  damaged z slices: {status}")
  if not ok:
    sys.exit(1)


def write_meta(src):
  binary = bload(src)
  path = src + ".meta"
  analytics.cache_meta(binary, path)
  print(f"wrote {path}")


def decompress_file(src, keep, z_range):
  binary = bload(src)
  z_start, z_end = None, None
  if z_range:
    parts = z_range.split(":")
    z_start = int(parts[0]) if parts[0] else None
    z_end = int(parts[1]) if len(parts) > 1 and parts[1] else None
  if z_start is not None or z_end is not None:
    arr = codec.decompress_range(binary, z_start, z_end, 0)
  else:
    arr = decompress(binary)
  dest = os.path.splitext(src)[0] + ".npy"
  np.save(dest, arr)
  print(f"wrote {dest}")
  if not keep:
    os.remove(src)


def compress_file(src, keep, pins, optimal_pins, markov):
  ext = util.normalize_file_ext(src)
  if ext == ".ckl":
    # reencode with the requested markov order / pin setting
    binary = bload(src)
    out = codec.reencode(binary, markov_model_order=markov)
    with open(src, 'wb') as f:
      f.write(out)
    print(f"reencoded {src} (markov={markov})")
    return

  image = util.load_any(src)
  allow_pins = 2 if optimal_pins else (1 if pins else 0)
  binary = _compress(image, allow_pins=allow_pins,
                     markov_model_order=markov)
  dest = os.path.splitext(src)[0] + ".ckl"
  with open(dest, 'wb') as f:
    f.write(binary)
  print(f"wrote {dest} ({len(binary)} bytes, "
        f"{len(binary) / max(image.nbytes, 1):.4%} of raw)")
  if not keep:
    os.remove(src)


if __name__ == "__main__":
  main()
