"""Stream-reduce: the kernel that reads an array once, for the card's
practical memory-read rate (the port of the Pallas roof kernels of
``tools/bench_roof.py:58`` and ``tools/probe_stream_scale.py:40``).

* ``stream_reduce`` wraps the hand-written CUDA kernel (``csrc/roof.cu``):
  given CUDA tensors it launches it (counting each launch in
  ``.launches``) or raises; given CPU tensors it runs the plain version.
* ``stream_reduce_ref`` is that plain version, ``c + x.sum(0)``.

The kernel sums in f64 in a fixed order and rounds once, so reruns are
bit-identical; against the plain version's f32 sum it agrees to the f32
rounding of ``sum |x|``.
"""
from __future__ import annotations

import torch

from icebin_tpu_torch.ops import _build
from icebin_tpu_torch.ops.apply import on_cpu

__all__ = ["stream_reduce", "stream_reduce_ref"]

#: pass-1 blocks to aim for: one wave of 8 per SM of an H100's 132
TARGET_BLOCKS = 132 * 8
#: columns of one pass-1 block (``kTileCols`` in ``roof.cu``)
TILE_COLS = 128


def stream_reduce_ref(x: torch.Tensor, c: torch.Tensor = None):
    """Plain version: (R, W) f32 -> (W,) f32, ``c + sum over rows``."""
    s = x.sum(0)
    return s if c is None else c + s


def stream_reduce(x: torch.Tensor, c: torch.Tensor = None) -> torch.Tensor:
    """``c + x.sum(0)`` for a contiguous (R, W) f32 ``x`` with R >= 1 and
    W a multiple of 4 (``c``: (W,) f32, zeros if None)."""
    R, W = x.shape if x.dim() == 2 else (0, 0)
    if (x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous()
            or R < 1 or W < 4 or W % 4):
        raise ValueError(f"stream_reduce needs a contiguous f32 (R >= 1, W "
                         f"a multiple of 4) array, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if c is not None and (c.dtype != torch.float32 or c.shape != (W,)
                          or c.device != x.device):
        raise ValueError(f"stream_reduce: c must be f32 ({W},) on "
                         f"{x.device}, got {c.dtype} {tuple(c.shape)} on "
                         f"{c.device}")
    if on_cpu(x, "stream_reduce"):
        return stream_reduce_ref(x, c)
    if x.data_ptr() % 16:
        raise ValueError("stream_reduce: x must be 16-byte aligned")
    c = (torch.zeros(W, dtype=torch.float32, device=x.device) if c is None
         else c.contiguous())
    tiles = -(-W // TILE_COLS)
    chunks = max(1, min(R, TARGET_BLOCKS // tiles))
    rows_per_chunk = -(-R // chunks)
    chunks = -(-R // rows_per_chunk)
    partial = torch.empty((chunks, W), dtype=torch.float64, device=x.device)
    out = torch.empty(W, dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = lib.stream_reduce(x.data_ptr(), c.data_ptr(),
                                   partial.data_ptr(), out.data_ptr(), R, W,
                                   rows_per_chunk, stream)
    _build.check(status, "stream_reduce")
    stream_reduce.launches += 1
    return out


stream_reduce.launches = 0
