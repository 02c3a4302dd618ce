"""Sublane<->lane folds of (32, 8) and (4, 64) tiles, the fold probe (the
port of the Pallas TPU instrument ``tools/probe_fold_ops.py:16``, bodies
``k_reshape_down`` :35, ``k_reshape_up`` :38, ``k_subslice_concat`` :41,
``k_laneslice_concat`` :46, ``k_block_fold`` :71 and ``k_block_reshape``
:78), on B tiles of f32 or f64:

* ``reshape_down``  (B, 32, 8) -> (B, 4, 64), row-major;
* ``reshape_up``    (B, 4, 64) -> (B, 32, 8), row-major;
* ``v1_fold``       (B, 32, 8) -> (B, 4, 64), ``out[t, 8r+v] = x[4r+t, v]``;
* ``v1_unfold``     (B, 4, 64) -> (B, 32, 8), ``out[4r+t, v] = x[t, 8r+v]``.

``fold_tiles`` wraps the hand-written CUDA kernel (``csrc/foldprobe.cu``):
one warp folds one tile, through shared memory (route ``smem``) or warp
shuffles (``shfl``).  Given a CUDA tensor it launches the kernel (counting
each launch in ``.launches``) or raises; given a CPU tensor it runs the
plain version, ``fold_tiles_ref``, whatever the route.  A fold is a
permutation, so kernel and plain version agree bit for bit.
"""
from __future__ import annotations

import torch

from icebin_tpu_torch.ops import _build
from icebin_tpu_torch.ops.apply import on_cpu

__all__ = ["FOLDS", "ROUTES", "DOWN", "fold_tiles", "fold_tiles_ref",
           "shapes"]

FOLDS = ("reshape_down", "reshape_up", "v1_fold", "v1_unfold")
ROUTES = ("smem", "shfl")
#: the folds that take (B, 32, 8) to (B, 4, 64); the others go back
DOWN = ("reshape_down", "v1_fold")


def shapes(fold: str) -> tuple[tuple[int, int], tuple[int, int]]:
    """(input, output) shape of one tile under ``fold``."""
    return ((32, 8), (4, 64)) if fold in DOWN else ((4, 64), (32, 8))


def fold_tiles_ref(x: torch.Tensor, fold: str) -> torch.Tensor:
    """Plain version, slicing as the JAX bodies slice: a new tensor."""
    B = x.shape[0]
    if fold == "reshape_down":
        return x.reshape(B, 4, 64).clone()
    if fold == "reshape_up":
        return x.reshape(B, 32, 8).clone()
    if fold == "v1_fold":            # 8 x (4-row slices) -> lane concat
        return torch.cat([x[:, r * 4:(r + 1) * 4, :] for r in range(8)],
                         dim=2)
    if fold == "v1_unfold":          # 8 x (8-lane slices) -> sublane concat
        return torch.cat([x[:, :, r * 8:(r + 1) * 8] for r in range(8)],
                         dim=1)
    raise ValueError(f"fold must be one of {FOLDS}, got {fold!r}")


def fold_tiles(x: torch.Tensor, fold: str, route: str) -> torch.Tensor:
    """``fold`` of each tile of the contiguous f32 or f64 ``x`` (B, 32, 8)
    or (B, 4, 64), as the fold takes it, through ``route``."""
    if fold not in FOLDS or route not in ROUTES:
        raise ValueError(f"fold_tiles: fold one of {FOLDS} and route one of "
                         f"{ROUTES}, got {fold!r}, {route!r}")
    tile_in, tile_out = shapes(fold)
    if (x.dtype not in (torch.float32, torch.float64) or x.dim() != 3
            or tuple(x.shape[1:]) != tile_in or not x.is_contiguous()):
        raise ValueError(f"fold_tiles {fold} needs a contiguous f32 or f64 "
                         f"(B, {tile_in[0]}, {tile_in[1]}) tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if on_cpu(x, "fold_tiles"):
        return fold_tiles_ref(x, fold)
    if x.data_ptr() % 16:
        raise ValueError("fold_tiles: x must be 16-byte aligned")
    B = x.shape[0]
    out = torch.empty((B, *tile_out), dtype=x.dtype, device=x.device)
    if B == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = lib.fold_tiles(x.data_ptr(), out.data_ptr(), B,
                                FOLDS.index(fold), ROUTES.index(route),
                                int(x.dtype == torch.float64), stream)
    _build.check(status, "fold_tiles")
    fold_tiles.launches += 1
    return out


fold_tiles.launches = 0
