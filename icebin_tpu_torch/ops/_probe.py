"""What the regrid kernels' probe wrappers (``ops/k2probe.py``,
``ops/k1probe.py``) share: one call of a variant at one parameter."""
from __future__ import annotations

import torch

from icebin_tpu_torch.ops.apply import _check_operands, _launch, on_cpu
from icebin_tpu_torch.ops.csr import Csr

__all__ = ["variant"]


def variant(wrap, ref, csr: Csr, x: torch.Tensor, param, allowed,
            flag: int) -> torch.Tensor:
    """Run a probe variant of a regrid kernel at ``param`` (one of
    ``allowed``, passed to the kernel as the int ``flag``): its plain
    version ``ref`` on CPU tensors, else the kernel ``wrap.__name__``,
    counted in ``wrap.launches``."""
    _check_operands(csr, x)
    if param not in allowed:
        raise ValueError(f"{wrap.__name__}: no kernel instance for {param!r} "
                         f"(one of {allowed})")
    if on_cpu(x, wrap.__name__):
        return ref(csr, x, param)
    out = _launch(wrap.__name__, csr, x, flag)
    wrap.launches += 1
    return out
