"""The port's own copy of ``icebin_tpu/oracle/clip.py``; it imports nothing of
the reference package.

CPU oracle: batched polygon-vs-rectangle clipping in float64 numpy.

This is the conservation referee for the TPU exchange-grid engine
(SURVEY.md section 7 stage 2).  The reference computes overlap polygons with
CGAL *exact* arithmetic (reference: ``slib/icebin/gridgen/GridGen_Exchange.*``
[U]); the TPU build replaces exactness with f64 (here) / recentered f32
(Pallas) clipping plus a conservation-repair normalization
(``icebin_tpu.grid.exchange``).

Algorithm -- batched Sutherland--Hodgman against axis-aligned rectangles,
designed to be *scatter-free and compaction-free* so the exact same data flow
runs on the TPU VPU:

* A polygon lives in a fixed-size vertex buffer; unused slots are filled with
  duplicates of a real vertex.  Duplicate vertices contribute zero-length
  edges, which both the clipper and the shoelace area treat as no-ops, so no
  vertex-count bookkeeping is needed.
* One half-plane pass maps a V-slot ring to a 2V-slot ring: edge k writes its
  entry-intersection to slot 2k and its endpoint to slot 2k+1, each with a
  validity flag; invalid slots are then overwritten with the nearest
  preceding valid vertex (a running-max index propagation + gather), which
  preserves ring order and degrades invalid slots to harmless duplicates.
* Clipping against a rect is 4 such passes (x>=x0, x<=x1, y>=y0, y<=y1), so a
  V0-vertex subject ends in a 16*V0 buffer; with V0 = 4 or 8 the final buffer
  is 64 or 128 slots -- exactly one TPU lane tile.

Everything is vectorized over the leading batch axis (one element per
candidate cell pair).
"""
from __future__ import annotations

import numpy as np

__all__ = ["clip_polys_rects", "clip_polys_polys", "polygon_areas",
           "polygon_centroids", "halfplane_pass"]


def _propagate_last_valid(pts: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Replace invalid slots with the nearest preceding valid vertex (ring).

    pts: (B, V, 2), valid: (B, V) bool.  Rows with no valid slot at all are
    filled with zeros (their area is zero anyway).
    """
    B, V, _ = pts.shape
    idx = np.where(valid, np.arange(V)[None, :], -1)
    idx = np.maximum.accumulate(idx, axis=1)            # (B, V) last valid <= k
    last = idx[:, -1]                                   # last valid per row
    any_valid = last >= 0
    # Leading invalid slots wrap to the ring's last valid vertex.
    idx = np.where(idx < 0, last[:, None], idx)
    idx = np.where(any_valid[:, None], idx, 0)
    out = np.take_along_axis(pts, idx[:, :, None], axis=1)
    out = np.where(any_valid[:, None, None], out, 0.0)
    return out


def halfplane_pass(pts: np.ndarray, d: np.ndarray) -> np.ndarray:
    """One Sutherland--Hodgman pass: keep region d >= 0.

    pts: (B, V, 2) vertex ring (duplicates allowed); d: (B, V) signed
    distances of each vertex to the clip line (positive = inside).
    Returns (B, 2V, 2) ring with duplicates as padding.
    """
    B, V, _ = pts.shape
    prev = np.roll(pts, 1, axis=1)
    dprev = np.roll(d, 1, axis=1)
    inside = d >= 0.0
    inside_prev = dprev >= 0.0
    crossing = inside != inside_prev
    denom = dprev - d
    safe = np.where(np.abs(denom) > 0.0, denom, 1.0)
    t = np.where(crossing, dprev / safe, 0.0)[:, :, None]
    inter = prev + t * (pts - prev)                     # (B, V, 2)

    out = np.empty((B, 2 * V, 2), dtype=pts.dtype)
    out[:, 0::2, :] = inter
    out[:, 1::2, :] = pts
    valid = np.empty((B, 2 * V), dtype=bool)
    valid[:, 0::2] = crossing
    valid[:, 1::2] = inside
    return _propagate_last_valid(out, valid)


def clip_polys_rects(polys: np.ndarray, rects: np.ndarray) -> np.ndarray:
    """Clip each polygon against its axis-aligned rectangle.

    polys: (B, V0, 2) vertex rings (CCW; duplicate padding allowed).
    rects: (B, 4) as (x0, y0, x1, y1).
    Returns the clipped rings, shape (B, 16*V0, 2), duplicates as padding.
    """
    p = polys
    x0 = rects[:, 0:1]
    y0 = rects[:, 1:2]
    x1 = rects[:, 2:3]
    y1 = rects[:, 3:4]
    p = halfplane_pass(p, p[:, :, 0] - x0)    # x >= x0
    p = halfplane_pass(p, x1 - p[:, :, 0])    # x <= x1
    p = halfplane_pass(p, p[:, :, 1] - y0)    # y >= y0
    p = halfplane_pass(p, y1 - p[:, :, 1])    # y <= y1
    return p


def clip_polys_polys(polys: np.ndarray, clips: np.ndarray) -> np.ndarray:
    """Clip each subject ring against its CONVEX clip ring (round 4:
    generic x generic / cross-projection exchange grids; the rect clipper
    above is the axis-aligned special case).

    polys: (B, V0, 2) subject rings (CCW; duplicate padding allowed).
    clips: (B, Vc, 2) convex clip rings, CCW; duplicate-vertex padding
    gives a zero-length edge whose half-plane test is d == 0 everywhere
    (keeps all) -- a no-op pass, so triangles pad to quads for free.
    Returns (B, 2^Vc * V0, 2) rings, duplicates as padding.
    """
    p = polys
    Vc = clips.shape[1]
    for k in range(Vc):
        a = clips[:, k, :]
        b = clips[:, (k + 1) % Vc, :]
        ex = (b - a)[:, None, :]                 # (B, 1, 2) edge vector
        # inside = left of the CCW edge: cross(b - a, p - a) >= 0
        d = (ex[:, :, 0] * (p[:, :, 1] - a[:, None, 1])
             - ex[:, :, 1] * (p[:, :, 0] - a[:, None, 0]))
        p = halfplane_pass(p, d)
    return p


def polygon_areas(rings: np.ndarray) -> np.ndarray:
    """Signed shoelace area per ring (B, V, 2) -> (B,).  CCW positive.
    Duplicate-vertex padding contributes exactly zero."""
    x = rings[:, :, 0]
    y = rings[:, :, 1]
    xn = np.roll(x, -1, axis=1)
    yn = np.roll(y, -1, axis=1)
    return 0.5 * np.sum(x * yn - xn * y, axis=1)


def polygon_centroids(rings: np.ndarray) -> np.ndarray:
    """Area centroids per ring -> (B, 2); zero-area rings get vertex 0."""
    x = rings[:, :, 0]
    y = rings[:, :, 1]
    xn = np.roll(x, -1, axis=1)
    yn = np.roll(y, -1, axis=1)
    cr = x * yn - xn * y
    a = 0.5 * np.sum(cr, axis=1)
    cx = np.sum((x + xn) * cr, axis=1)
    cy = np.sum((y + yn) * cr, axis=1)
    safe = np.where(np.abs(a) > 0.0, 6.0 * a, 1.0)
    c = np.stack([cx, cy], axis=-1) / safe[:, None]
    deg = (np.abs(a) <= 0.0)[:, None]
    return np.where(deg, rings[:, 0, :], c)
