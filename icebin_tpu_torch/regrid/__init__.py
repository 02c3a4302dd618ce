"""Regridder whose sheets build through the port, and the reference's
sparse-matrix class (numpy, no JAX), re-exported for the port's users."""
from icebin_tpu.regrid.sparse import WeightedMatrix

__all__ = ["WeightedMatrix"]
