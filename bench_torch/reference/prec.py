"""The precisions the reference computes in.

The configurations state f32 fields and regrid applies (sums in f64, TF32
off) and f64 books: the mass repair, the ledger, the exchange geometry, the
TOPO fields and the E1vE0 remap.  ``REFERENCE`` computes in exactly those.
``CONTROL`` is the reference one step lower in each, the step a faster
version would be tempted by: every f64 quantity in f32, and the applies'
matrix values and fields rounded to TF32 (10 mantissa bits) with f32 sums.
A sound program must read clearly closer to ``REFERENCE`` than ``CONTROL``
does; the benchmark's limits sit between the two readings.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch


def keep(x):
    return x


def tf32(x):
    """Round f32 (or f64, through f32) to TF32's 10 mantissa bits, to
    nearest even, as the tensor cores read an f32 operand."""
    x = x.to(torch.float32).contiguous()
    b = x.view(torch.int32)
    lsb = (b >> 13) & 1
    b = (b + 0x0FFF + lsb) & ~0x1FFF
    out = b.view(torch.float32)
    return torch.where(torch.isfinite(x), out, x)


@dataclasses.dataclass(frozen=True)
class Prec:
    name: str
    books: torch.dtype        # repair, ledger, weights, TOPO, E1vE0
    geom: torch.dtype         # exchange-grid clip coordinates
    rnd: Callable             # rounding of clip coordinates
    acc: torch.dtype          # accumulation of a regrid apply
    field: Callable           # rounding of an apply's values and field


REFERENCE = Prec("reference", torch.float64, torch.float64, keep,
                 torch.float64, keep)
CONTROL = Prec("control", torch.float32, torch.float32, tf32,
               torch.float32, tf32)
