"""Regridder, matrix factories and the sparse-matrix class: the port's own
copies of the reference's host modules (numpy), with the regridder's
exchange grids built through the port's clip kernels."""
from icebin_tpu_torch.regrid.sparse import WeightedMatrix

__all__ = ["WeightedMatrix"]
