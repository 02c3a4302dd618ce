"""Batched polygon-vs-rectangle clipping: the port of
``icebin_tpu/ops/clip.py`` (``clip_areas_centroids``, ``make_clip_engine``)
and of the Pallas kernel ``icebin_tpu/ops/pallas_clip.py:_clip_kernel``.

* ``clip_areas_centroids_ref`` is the plain PyTorch version: the reference's
  vectorised Sutherland--Hodgman data flow (each pass doubles the ring and
  forward-fills invalid slots, ``icebin_tpu/oracle/clip.py`` docstring),
  followed by the shoelace area and centroid.
* ``clip_areas_centroids`` wraps the CUDA kernel (``csrc/clip.cu``): on CUDA
  tensors it launches the kernel (counting launches in ``.launches``) or
  raises; on CPU tensors it runs the plain version.
"""
from __future__ import annotations

import numpy as np
import torch

from icebin_tpu_torch.ops import _build
from icebin_tpu_torch.ops.apply import on_cpu

__all__ = ["clip_areas_centroids", "clip_areas_centroids_ref",
           "make_clip_engine", "recentre_pairs", "KERNEL_V0"]

#: subject ring slot counts the kernel is built for (duplicate-padded up)
KERNEL_V0 = (8, 16)


def _propagate_last_valid(pts, valid):
    """(B, V, 2), (B, V) -> invalid slots replaced by the nearest preceding
    valid vertex (ring wrap); rows with no valid slot become all-zero."""
    B, V, _ = pts.shape
    slot = torch.arange(V, device=pts.device).expand(B, V)
    idx = torch.where(valid, slot, -1)
    idx = torch.cummax(idx, dim=1).values
    last = idx[:, -1:]
    any_valid = last >= 0
    idx = torch.where(idx < 0, last, idx)
    idx = torch.where(any_valid, idx, 0)
    out = torch.gather(pts, 1, idx[:, :, None].expand(B, V, 2))
    return torch.where(any_valid[:, :, None], out, 0.0)


def _halfplane_pass(pts, d):
    """One S--H pass keeping d >= 0; (B, V, 2) -> (B, 2V, 2)."""
    prev = torch.roll(pts, 1, dims=1)
    dprev = torch.roll(d, 1, dims=1)
    inside = d >= 0.0
    crossing = inside != (dprev >= 0.0)
    denom = dprev - d
    safe = torch.where(denom.abs() > 0.0, denom, 1.0)
    t = torch.where(crossing, dprev / safe, 0.0)[:, :, None]
    inter = prev + t * (pts - prev)
    out = torch.stack([inter, pts], dim=2).reshape(pts.shape[0], -1, 2)
    valid = torch.stack([crossing, inside], dim=2).reshape(pts.shape[0], -1)
    return _propagate_last_valid(out, valid)


def clip_areas_centroids_ref(polys: torch.Tensor, rects: torch.Tensor):
    """Plain version: polys (B, V0, 2), rects (B, 4) as (x0, y0, x1, y1) ->
    (signed areas (B,), centroids (B, 2)); zero-area rings get slot 0."""
    p = polys
    p = _halfplane_pass(p, p[:, :, 0] - rects[:, 0:1])     # x >= x0
    p = _halfplane_pass(p, rects[:, 2:3] - p[:, :, 0])     # x <= x1
    p = _halfplane_pass(p, p[:, :, 1] - rects[:, 1:2])     # y >= y0
    p = _halfplane_pass(p, rects[:, 3:4] - p[:, :, 1])     # y <= y1
    x, y = p[:, :, 0], p[:, :, 1]
    xn, yn = torch.roll(x, -1, dims=1), torch.roll(y, -1, dims=1)
    cr = x * yn - xn * y
    a = 0.5 * cr.sum(dim=1)
    c = torch.stack([((x + xn) * cr).sum(dim=1),
                     ((y + yn) * cr).sum(dim=1)], dim=-1)
    safe = torch.where(a.abs() > 0.0, 6.0 * a, 1.0)
    c = torch.where((a.abs() <= 0.0)[:, None], p[:, 0, :], c / safe[:, None])
    return a, c


def clip_areas_centroids(polys: torch.Tensor, rects: torch.Tensor):
    """Clip kernel wrapper.  polys (B, V0, 2) f32 with V0 in ``KERNEL_V0``,
    rects (B, 4) f32 CENTRED on the origin (x0 = -x1, y0 = -y1: the kernel
    clips against the half extents).  Returns (areas (B,), centroids
    (B, 2)) f32."""
    B, v0 = polys.shape[0], polys.shape[1]
    if (polys.dtype != torch.float32 or rects.dtype != torch.float32
            or polys.shape != (B, v0, 2) or rects.shape != (B, 4)
            or v0 not in KERNEL_V0 or rects.device != polys.device):
        raise ValueError(f"clip kernel needs f32 polys (B, v0 in {KERNEL_V0},"
                         f" 2) and rects (B, 4) on one device, got "
                         f"{polys.dtype} {tuple(polys.shape)} / {rects.dtype}"
                         f" {tuple(rects.shape)}")
    if on_cpu(polys, "clip_areas_centroids"):
        return clip_areas_centroids_ref(polys, rects)
    polys, rects = polys.contiguous(), rects.contiguous()
    area = torch.empty(B, dtype=torch.float32, device=polys.device)
    cent = torch.empty((B, 2), dtype=torch.float32, device=polys.device)
    lib = _build.library()
    with torch.cuda.device(polys.device):
        stream = torch.cuda.current_stream(polys.device).cuda_stream
        status = lib.clip_rect(polys.data_ptr(), rects.data_ptr(),
                               area.data_ptr(), cent.data_ptr(), B, v0,
                               stream)
    _build.check(status, "clip_rect")
    clip_areas_centroids.launches += 1
    return area, cent


clip_areas_centroids.launches = 0


def recentre_pairs(subj: np.ndarray, rect: np.ndarray):
    """Kernel inputs for world-coordinate pairs, as
    ``icebin_tpu/grid/exchange.py:557-562`` makes them: each pair is
    recentred on its rectangle in f64 and then cast to f32, so in-kernel
    coordinates are O(cell size); rings pad to the next ``KERNEL_V0`` by
    repeating their last vertex (a zero-length edge adds nothing).
    Returns (polys (B, V0, 2) f32, rects (B, 4) f32, centres (B, 2) f64)."""
    subj = np.asarray(subj, np.float64)
    rect = np.asarray(rect, np.float64)
    v0 = next((k for k in KERNEL_V0 if subj.shape[1] <= k), None)
    if v0 is None:
        raise ValueError(f"the clip kernel takes <= {KERNEL_V0[-1]} subject "
                         f"vertices (got {subj.shape[1]}); use subdiv <= 4")
    if subj.shape[1] < v0:
        pad = np.repeat(subj[:, -1:, :], v0 - subj.shape[1], axis=1)
        subj = np.concatenate([subj, pad], axis=1)
    c = 0.5 * (rect[:, 0:2] + rect[:, 2:4])
    polys = (subj - c[:, None, :]).astype(np.float32)
    rects = (rect - np.concatenate([c, c], axis=1)).astype(np.float32)
    return polys, rects, c


def make_clip_engine(*, device, chunk: int = 1 << 18):
    """Returns fn(subj (B, V0, 2), rect (B, 4)) -> (areas, centroids), numpy
    f64 in world coordinates: |area| per pair and its centroid.  Pairs are
    recentred by ``recentre_pairs`` and clipped on ``device`` in chunks."""
    device = torch.device(device)

    def fn(subj: np.ndarray, rect: np.ndarray):
        polys, rects, c = recentre_pairs(subj, rect)
        B = polys.shape[0]
        areas = np.empty(B, np.float64)
        cents = np.empty((B, 2), np.float64)
        for s in range(0, B, chunk):
            e = min(s + chunk, B)
            a, ctr = clip_areas_centroids(
                torch.as_tensor(polys[s:e], device=device),
                torch.as_tensor(rects[s:e], device=device))
            areas[s:e] = np.abs(a.cpu().numpy().astype(np.float64))
            cents[s:e] = ctr.cpu().numpy().astype(np.float64) + c[s:e]
        return areas, cents

    return fn
