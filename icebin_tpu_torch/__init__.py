"""icebin_tpu_torch: the PyTorch + CUDA port of icebin_tpu's coupled main
path, for NVIDIA Hopper (H100).

``icebin_tpu`` (JAX) stays the reference.  This package imports its host
layer (grids, exchange-grid stages, matrix factories, unit contracts,
E1vE0), none of which imports JAX, and re-implements on ``torch`` every
module that does: the regrid applies, the f64 ledger, the SIA ice model,
the coupler and the exchange-grid clip.  The three Pallas kernels on that
path are hand-written CUDA in ``csrc/`` (built at first use by
``icebin_tpu_torch.ops._build``).  Layout mirrors the reference:

    ops/       csr pack, applies (dest-small/dest-ice kernels), clip kernel
    coupler/   ledger, coupler
    models/    ice_sheet
    grid/      exchange (clip through the kernel)
    regrid/    gcmregridder (sheets built through grid/exchange)
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
