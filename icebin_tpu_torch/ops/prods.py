"""Batched tile product, the depth-scaling instrument (the port of the
Pallas TPU instrument ``tools/probe_prods_scale.py:69``, body ``kernel``
:46): ``out[b, i, j] = sum_c T[b, i, c] * F[b, j, c]`` for f32 T (B, 32,
128) and F (B, 8, 128).

* ``tile_prods`` wraps the hand-written CUDA kernel (``csrc/prods.cu``):
  given CUDA tensors it launches it (counting each launch in
  ``.launches``) or raises; given CPU tensors it runs the plain version.
* ``tile_prods_ref`` is that plain version: the product in f64, rounded to
  f32 once.

The kernel runs an f32 multiply-add chain of 128 terms per output, so it
agrees with the plain version within ``130 * 2**-24 * sum_c |T * F|``
(the chain's rounding bound).  The TPU probe's 3-pass split-bf16 product
drops the lo * lo term and rounds the lo parts to bf16: about ``2**-16 *
sum_c |T * F|``.
"""
from __future__ import annotations

import torch

from icebin_tpu_torch.ops import _build
from icebin_tpu_torch.ops.apply import on_cpu

__all__ = ["tile_prods", "tile_prods_ref", "ROWS", "FIELDS", "DEPTH"]

ROWS, FIELDS, DEPTH = 32, 8, 128


def tile_prods_ref(T: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
    """Plain version: (B, 32, 128) x (B, 8, 128) f32 -> (B, 32, 8) f32."""
    return torch.matmul(T.double(), F.double().transpose(1, 2)).float()


def tile_prods(T: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
    """``out[b] = T[b] @ F[b].T`` for contiguous f32 T (B, 32, 128) and F
    (B, 8, 128) on one device."""
    B = T.shape[0] if T.dim() == 3 else -1
    if (T.dtype != torch.float32 or F.dtype != torch.float32
            or T.shape != (B, ROWS, DEPTH) or F.shape != (B, FIELDS, DEPTH)
            or not (T.is_contiguous() and F.is_contiguous())
            or F.device != T.device):
        raise ValueError(f"tile_prods needs contiguous f32 T (B, {ROWS}, "
                         f"{DEPTH}) and F (B, {FIELDS}, {DEPTH}) on one "
                         f"device, got {T.dtype} {tuple(T.shape)} on "
                         f"{T.device} / {F.dtype} {tuple(F.shape)} on "
                         f"{F.device}")
    if on_cpu(T, "tile_prods"):
        return tile_prods_ref(T, F)
    if T.data_ptr() % 16 or F.data_ptr() % 16:
        raise ValueError("tile_prods: T and F must be 16-byte aligned")
    out = torch.empty((B, ROWS, FIELDS), dtype=torch.float32,
                      device=T.device)
    lib = _build.library()
    with torch.cuda.device(T.device):
        stream = torch.cuda.current_stream(T.device).cuda_stream
        status = lib.tile_prods(T.data_ptr(), F.data_ptr(), out.data_ptr(),
                                B, stream)
    _build.check(status, "tile_prods")
    tile_prods.launches += 1
    return out


tile_prods.launches = 0
