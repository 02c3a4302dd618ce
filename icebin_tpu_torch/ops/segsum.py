"""Ordered f64 segment sum, the building block of regeneration on the card.

* ``segment_sum`` wraps the hand-written CUDA kernel
  (``csrc/segsum.cu``): given CUDA tensors it launches it (counting each
  launch in ``.launches``) or raises; given CPU tensors it runs the plain
  version.
* ``segment_sum_ref`` is that plain version.

Both add each segment's values left to right, starting from 0.0: the
order ``np.add.at`` and ``np.bincount(..., weights=)`` add a run of equal
keys in, so after a stable sort of the same entries by key the sums are
numpy's bit for bit.  No float atomics, no tree.
"""
from __future__ import annotations

import torch

from icebin_tpu_torch.ops import _build
from icebin_tpu_torch.ops.apply import on_cpu

__all__ = ["segment_sum", "segment_sum_ref"]


def segment_sum_ref(vals: torch.Tensor, offsets: torch.Tensor):
    """Plain version: (nseg,) f64, segment s the sum of ``vals[offsets[s]
    : offsets[s + 1]]`` added left to right from 0.0.  One vectorised add
    per position in a segment, over the segments that long, longest
    first."""
    lens = offsets[1:] - offsets[:-1]
    out = torch.zeros(len(lens), dtype=torch.float64, device=vals.device)
    if not len(lens) or not int(lens.max()):
        return out
    order = torch.argsort(lens, descending=True, stable=True)
    start = offsets[:-1][order]
    acc = torch.zeros_like(out)
    # longer[j]: how many segments are longer than j (a prefix of order)
    longer = len(lens) - torch.cumsum(torch.bincount(lens), 0)
    for j, k in enumerate(longer.tolist()):
        if not k:
            break
        acc[:k] += vals[start[:k] + j]
    out[order] = acc
    return out


def segment_sum(vals: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """(nseg,) f64 ordered sums of a contiguous f64 ``vals`` over the
    segments [offsets[s], offsets[s + 1]) of a non-decreasing int64
    ``offsets`` (nseg + 1,) within ``vals``."""
    if (vals.dtype != torch.float64 or vals.dim() != 1
            or offsets.dtype != torch.int64 or offsets.dim() != 1
            or len(offsets) < 1 or offsets.device != vals.device):
        raise ValueError(f"segment_sum needs (n,) f64 values and (nseg + "
                         f"1,) int64 offsets on one device, got "
                         f"{vals.dtype} {tuple(vals.shape)} on {vals.device}"
                         f" and {offsets.dtype} {tuple(offsets.shape)} on "
                         f"{offsets.device}")
    nseg = len(offsets) - 1
    if nseg >= 2 ** 31:
        raise ValueError(f"segment_sum: {nseg} segments need 64-bit "
                         f"indexing")
    if on_cpu(vals, "segment_sum"):
        return segment_sum_ref(vals, offsets)
    vals, offsets = vals.contiguous(), offsets.contiguous()
    out = torch.empty(nseg, dtype=torch.float64, device=vals.device)
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        status = _build.library().segment_sum(
            vals.data_ptr(), offsets.data_ptr(), out.data_ptr(), nseg,
            stream)
    _build.check(status, "segment_sum")
    segment_sum.launches += 1
    return out


segment_sum.launches = 0
