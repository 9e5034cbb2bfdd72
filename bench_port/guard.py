"""The run's guard against the JAX reference package.

The program under test is crackle_tpu_torch. The package it was ported
from (crackle_tpu) and JAX are never measured, so a run that finds any
of them loaded prints no result. Modules are compared by their whole
top-level name, the part before the first dot, so crackle_tpu_torch
passes where crackle_tpu does not.
"""
import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "crackle_tpu"})


def forbidden_loaded(modules=None):
  """Sorted top-level names of loaded modules that a run may not hold."""
  names = sys.modules if modules is None else modules
  return sorted({m.split(".")[0] for m in names} & FORBIDDEN)
