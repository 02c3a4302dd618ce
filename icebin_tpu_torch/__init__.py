"""icebin_tpu_torch: the PyTorch + CUDA port of icebin_tpu, for NVIDIA
Hopper (H100).

``icebin_tpu`` (JAX) stays the reference.  This package imports nothing of
it: the host layer it needs (grids and projections, the exchange-grid
stages, the sparse-matrix and matrix factories, the smoother, the NetCDF
and zarray files, unit contracts, E1vE0) is its own numpy copy of the
reference's modules, under the same relative paths and bit-identical, and
every module that runs on JAX is re-implemented on ``torch``: the regrid
applies, the f64 ledger, the SIA and DISMAL ice models, the coupler with
its writer and checkpoints, the exchange-grid clip and the ``overlap`` and
``run`` CLIs.  The Pallas kernels on those paths are hand-written CUDA in
``csrc/`` (built at first use by ``icebin_tpu_torch.ops._build``).  Layout
mirrors the reference:

    ops/       csr pack, applies (dest-small/dest-ice kernels), clip
               kernels, stream-reduce kernel (roof), smoother
    coupler/   ledger, coupler, writer, checkpoint, units, varset, e1ve0
    models/    ice_sheet, dismal
    grid/      proj, spec, decompose, exchange (clip through the kernels)
    regrid/    sparse, hntr, matrices, gcmregridder
    io/        ncio, zarray
    oracle/    clip (the f64 numpy clip)
    utils/     indexing, config (RunConfig)
    cli/       overlap, run
    convert    ice state to and from the reference's arrays

Every constructor takes an explicit ``device``; functions on tensors run
where their tensors are.
"""
import torch

# No kernel of the port uses TF32; keep PyTorch's own f32 paths full-width.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from icebin_tpu_torch.coupler.coupler import (CouplerConfig,  # noqa: E402
                                              GCMCoupler, IceSheetCoupler)
from icebin_tpu_torch.regrid.gcmregridder import GCMRegridder  # noqa: E402

__all__ = ["CouplerConfig", "GCMCoupler", "GCMRegridder", "IceSheetCoupler"]
