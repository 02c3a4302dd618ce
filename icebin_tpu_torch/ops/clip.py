"""Batched polygon clipping: the port of ``icebin_tpu/ops/clip.py``
(``clip_areas_centroids``, ``make_clip_engine``, ``clip_areas_centroids_poly``,
``make_polyclip_engine``) and of the Pallas kernels
``icebin_tpu/ops/pallas_clip.py:_clip_kernel`` and ``:_polyclip_kernel``.

* ``clip_areas_centroids_ref`` (subject rings x centred rectangles) and
  ``clip_areas_centroids_poly_ref`` (subject rings x convex clip rings) are
  the plain PyTorch versions: the reference's vectorised Sutherland--Hodgman
  data flow (each pass doubles the ring and forward-fills invalid slots,
  ``icebin_tpu/oracle/clip.py`` docstring), followed by the shoelace area
  and centroid.
* ``clip_areas_centroids`` and ``clip_areas_centroids_poly`` wrap the CUDA
  kernels ``clip_rect`` and ``clip_poly`` (``csrc/clip.cu``, stage 2: the
  register pipeline): on CUDA tensors they launch the kernel (counting
  launches in ``.launches``) or raise; on CPU tensors they run the plain
  version.  ``clip_areas_centroids_compact`` and
  ``clip_areas_centroids_poly_compact`` do the same for the stage-1
  kernels (``clip_rect_compact``, ``clip_poly_compact``), kept as the
  yardstick; nothing on the main path calls them.  ``clip_stream_at``
  launches stage 2 at an explicit geometry (the sweep, the card tests).
* ``clip_stream_model`` is stage 2's arithmetic in numpy scalars, pair by
  pair in the kernel's order: bit for bit the kernel's result, a test
  oracle that nothing on a path calls.
* ``make_clip_engine`` and ``make_polyclip_engine`` take world-coordinate
  pairs, recentre each in f64, pad rings to the kernel's slot counts and
  clip on a device in chunks.
"""
from __future__ import annotations

import numpy as np
import torch

from icebin_tpu_torch.ops import _build
from icebin_tpu_torch.ops.apply import on_cpu

__all__ = ["clip_areas_centroids", "clip_areas_centroids_ref",
           "clip_areas_centroids_compact", "clip_areas_centroids_poly",
           "clip_areas_centroids_poly_ref",
           "clip_areas_centroids_poly_compact", "clip_stream_at",
           "clip_stream_model", "make_clip_engine", "make_polyclip_engine",
           "recentre_pairs", "recentre_poly_pairs", "KERNEL_V0",
           "KERNEL_VC", "ROUTES"]

#: subject ring slot counts the kernels are built for (duplicate-padded up)
KERNEL_V0 = (8, 16)
#: clip ring slot counts of the convex-clip kernel (duplicate-padded up)
KERNEL_VC = (4, 8)
#: pairs per step of the plain convex clip, which holds V0 * 2**Vc slots
#: (16-32 KB) per pair
PLAIN_CHUNK = 1 << 14
#: how stage 2 brings a subject ring to its thread (``clip_stream_at``):
#: 16-byte loads into registers, or cp.async into shared memory
ROUTES = ("vector", "staged")


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


def _area_centroid(p):
    """Shoelace (signed areas (B,), centroids (B, 2)) of rings (B, V, 2);
    zero-area rings get slot 0."""
    x, y = p[:, :, 0], p[:, :, 1]
    xn, yn = torch.roll(x, -1, dims=1), torch.roll(y, -1, dims=1)
    cr = x * yn - xn * y
    a = 0.5 * cr.sum(dim=1)
    c = torch.stack([((x + xn) * cr).sum(dim=1),
                     ((y + yn) * cr).sum(dim=1)], dim=-1)
    safe = torch.where(a.abs() > 0.0, 6.0 * a, 1.0)
    c = torch.where((a.abs() <= 0.0)[:, None], p[:, 0, :], c / safe[:, None])
    return a, c


def clip_areas_centroids_ref(polys: torch.Tensor, rects: torch.Tensor):
    """Plain version: polys (B, V0, 2), rects (B, 4) as (x0, y0, x1, y1) ->
    (signed areas (B,), centroids (B, 2)); zero-area rings get slot 0."""
    p = polys
    p = _halfplane_pass(p, p[:, :, 0] - rects[:, 0:1])     # x >= x0
    p = _halfplane_pass(p, rects[:, 2:3] - p[:, :, 0])     # x <= x1
    p = _halfplane_pass(p, p[:, :, 1] - rects[:, 1:2])     # y >= y0
    p = _halfplane_pass(p, rects[:, 3:4] - p[:, :, 1])     # y <= y1
    return _area_centroid(p)


def _clip_poly_rings(polys, clips):
    """``icebin_tpu/ops/clip.py:clip_polys_polys``: one pass per clip edge
    a -> b keeping d = cross(b - a, p - a) >= 0; (B, V0, 2) -> (B, V0 *
    2**Vc, 2)."""
    p = polys
    vc = clips.shape[1]
    for k in range(vc):
        a = clips[:, k, :]
        ex = clips[:, (k + 1) % vc, :] - a
        d = (ex[:, None, 0] * (p[:, :, 1] - a[:, None, 1])
             - ex[:, None, 1] * (p[:, :, 0] - a[:, None, 0]))
        p = _halfplane_pass(p, d)
    return p


def clip_areas_centroids_poly_ref(polys: torch.Tensor, clips: torch.Tensor):
    """Plain version: polys (B, V0, 2) x convex CCW clip rings (B, Vc, 2)
    -> (signed areas (B,), centroids (B, 2)); zero-area rings get slot 0.
    Runs ``PLAIN_CHUNK`` pairs at a time."""
    if polys.shape[0] == 0:
        return (polys.new_zeros(0), polys.new_zeros((0, 2)))
    parts = [_area_centroid(_clip_poly_rings(polys[s:s + PLAIN_CHUNK],
                                             clips[s:s + PLAIN_CHUNK]))
             for s in range(0, polys.shape[0], PLAIN_CHUNK)]
    return (torch.cat([a for a, _ in parts]),
            torch.cat([c for _, c in parts]))


def _launch(name, polys, other, *sizes):
    """Run C entry point ``name`` on f32 (polys, other); returns (areas,
    centroids).  The kernels read 16-byte vectors, so an operand that does
    not start on 16 bytes is copied first."""
    polys, other = polys.contiguous(), other.contiguous()
    polys, other = (t if t.data_ptr() % 16 == 0 else t.clone()
                    for t in (polys, other))
    B = polys.shape[0]
    area = torch.empty(B, dtype=torch.float32, device=polys.device)
    cent = torch.empty((B, 2), dtype=torch.float32, device=polys.device)
    lib = _build.library()
    with torch.cuda.device(polys.device):
        stream = torch.cuda.current_stream(polys.device).cuda_stream
        status = getattr(lib, name)(polys.data_ptr(), other.data_ptr(),
                                    area.data_ptr(), cent.data_ptr(), B,
                                    *sizes, stream)
    _build.check(status, name)
    return area, cent


def _rect_sizes(polys: torch.Tensor, rects: torch.Tensor):
    """(v0,) of a rectangle clip's operands; raises on what the kernels do
    not take."""
    B, v0 = polys.shape[0], polys.shape[1]
    if (polys.dtype != torch.float32 or rects.dtype != torch.float32
            or polys.shape != (B, v0, 2) or rects.shape != (B, 4)
            or v0 not in KERNEL_V0 or rects.device != polys.device):
        raise ValueError(f"clip kernel needs f32 polys (B, v0 in {KERNEL_V0},"
                         f" 2) and rects (B, 4) on one device, got "
                         f"{polys.dtype} {tuple(polys.shape)} / {rects.dtype}"
                         f" {tuple(rects.shape)}")
    return (v0,)


def _poly_sizes(polys: torch.Tensor, clips: torch.Tensor):
    """(v0, vc) of a convex clip's operands; raises on what the kernels do
    not take."""
    B, v0 = polys.shape[0], polys.shape[1]
    vc = clips.shape[1] if clips.dim() == 3 else 0
    if (polys.dtype != torch.float32 or clips.dtype != torch.float32
            or polys.shape != (B, v0, 2) or clips.shape != (B, vc, 2)
            or v0 not in KERNEL_V0 or vc not in KERNEL_VC
            or clips.device != polys.device):
        raise ValueError(f"convex-clip kernel needs f32 polys (B, v0 in "
                         f"{KERNEL_V0}, 2) and clips (B, vc in {KERNEL_VC}, "
                         f"2) on one device, got {polys.dtype} "
                         f"{tuple(polys.shape)} / {clips.dtype} "
                         f"{tuple(clips.shape)}")
    return v0, vc


def clip_areas_centroids(polys: torch.Tensor, rects: torch.Tensor):
    """Clip kernel wrapper (stage 2).  polys (B, V0, 2) f32 with V0 in
    ``KERNEL_V0``, rects (B, 4) f32 CENTRED on the origin (x0 = -x1, y0 =
    -y1: the kernel clips against the half extents).  Returns (areas (B,),
    centroids (B, 2)) f32."""
    sizes = _rect_sizes(polys, rects)
    if on_cpu(polys, "clip_areas_centroids"):
        return clip_areas_centroids_ref(polys, rects)
    out = _launch("clip_rect", polys, rects, *sizes)
    clip_areas_centroids.launches += 1
    return out


def clip_areas_centroids_compact(polys: torch.Tensor, rects: torch.Tensor):
    """``clip_areas_centroids`` through the stage-1 kernel (each pass
    compacts its ring into per-thread buffers)."""
    sizes = _rect_sizes(polys, rects)
    if on_cpu(polys, "clip_areas_centroids_compact"):
        return clip_areas_centroids_ref(polys, rects)
    out = _launch("clip_rect_compact", polys, rects, *sizes)
    clip_areas_centroids_compact.launches += 1
    return out


def clip_areas_centroids_poly(polys: torch.Tensor, clips: torch.Tensor):
    """Convex-clip kernel wrapper (stage 2).  polys (B, V0, 2) f32 with V0
    in ``KERNEL_V0``, clips (B, Vc, 2) f32 convex CCW rings with Vc in
    ``KERNEL_VC`` (duplicate-padded), both recentred on the clip ring.
    Returns (areas (B,), centroids (B, 2)) f32."""
    sizes = _poly_sizes(polys, clips)
    if on_cpu(polys, "clip_areas_centroids_poly"):
        return clip_areas_centroids_poly_ref(polys, clips)
    out = _launch("clip_poly", polys, clips, *sizes)
    clip_areas_centroids_poly.launches += 1
    return out


def clip_areas_centroids_poly_compact(polys: torch.Tensor,
                                      clips: torch.Tensor):
    """``clip_areas_centroids_poly`` through the stage-1 kernel."""
    sizes = _poly_sizes(polys, clips)
    if on_cpu(polys, "clip_areas_centroids_poly_compact"):
        return clip_areas_centroids_poly_ref(polys, clips)
    out = _launch("clip_poly_compact", polys, clips, *sizes)
    clip_areas_centroids_poly_compact.launches += 1
    return out


for _f in (clip_areas_centroids, clip_areas_centroids_compact,
           clip_areas_centroids_poly, clip_areas_centroids_poly_compact):
    _f.launches = 0


def clip_stream_at(polys: torch.Tensor, other: torch.Tensor, threads: int,
                   min_blocks: int, route: str):
    """Stage 2 on CUDA tensors at an explicit geometry, uncounted: rects
    (B, 4) as ``clip_areas_centroids`` takes them or clip rings (B, Vc, 2)
    as ``clip_areas_centroids_poly`` does; ``threads`` a block (a multiple
    of 32 up to 256), ``min_blocks`` of 256 threads the compiler must fit
    on an SM (1; 2 also for the shapes ``tools/sweep_clip.py`` sweeps),
    ``route`` in ``ROUTES``."""
    sizes = (_rect_sizes(polys, other) + (0,) if other.dim() == 2
             else _poly_sizes(polys, other))
    if polys.device.type != "cuda":
        raise ValueError(f"clip_stream_at launches on the card, got "
                         f"{polys.device}")
    return _launch("clip_stream_at", polys, other, *sizes, threads,
                   min_blocks, ROUTES.index(route))


# -- stage 2's arithmetic in numpy scalars -----------------------------------

_F = np.float32


def _fma32(a, b, c):
    """f32 ``a * b + c`` rounded once, as ``__fmaf_rn``: the product is
    exact in f64, and where the f64 sum lands halfway between two f32
    values its rounding error (TwoSum) decides the side."""
    a, b, c = float(a), float(b), float(c)
    p = a * b
    s = p + c
    bp = s - p
    e = (p - (s - bp)) + (c - bp)
    r = _F(s)
    if e != 0.0 and np.isfinite(r) and s != float(r):
        toward = np.nextafter(r, _F(np.copysign(np.inf, s - float(r))))
        if s - float(r) == float(toward) - s and (e > 0) == (toward > r):
            r = toward
    return r


def _crossing(xp, yp, dp, x, y, d):
    """The point where the edge (xp, yp) -> (x, y) crosses d = 0, as both
    kernels compute it: t = dp / (dp - d) (1 for a zero denominator), then
    xp + t (x - xp) as one FMA."""
    den = dp - d
    t = dp / (den if abs(den) > 0 else _F(1))
    return _fma32(t, x - xp, xp), _fma32(t, y - yp, yp)


def _stream_stage(ring, dist):
    """One pipeline stage over the ring it receives, in the order it emits:
    the group of each edge (k - 1 -> k) for k = 1 .. n - 1 (its crossing
    point if the side changes, then vertex k if inside), then the group of
    the closing edge (n - 1 -> 0).  ``dist`` None passes the ring
    through."""
    if dist is None or not ring:
        return ring
    ds = [dist(x, y) for x, y in ring]
    out = []
    for k in list(range(1, len(ring))) + [0]:
        (xp, yp), dp = ring[k - 1], ds[k - 1]
        (x, y), d = ring[k], ds[k]
        inside = d >= 0
        if inside != (dp >= 0):
            out.append(_crossing(xp, yp, dp, x, y, d))
        if inside:
            out.append((x, y))
    return out


def _stream_dists(other):
    """The stages' distance functions (f32 scalars) for one rectangle (4,)
    or clip ring (Vc, 2); None for a zero-length clip edge."""
    o = [_F(v) for v in np.asarray(other, np.float32).reshape(-1)]
    if len(o) == 4 and np.ndim(other) == 1:
        hx, hy = _F(0.5) * (o[2] - o[0]), _F(0.5) * (o[3] - o[1])
        return [lambda x, y: x + hx, lambda x, y: hx - x,
                lambda x, y: y + hy, lambda x, y: hy - y]
    q = list(zip(o[0::2], o[1::2]))
    out = []
    for k, (x0, y0) in enumerate(q):
        x1, y1 = q[(k + 1) % len(q)]
        ex, ey = x1 - x0, y1 - y0
        out.append(None if ex == 0 and ey == 0 else
                   (lambda x, y, x0=x0, y0=y0, ex=ex, ey=ey:
                    ex * (y - y0) - ey * (x - x0)))
    return out


def _stream_ring(ring, other):
    """The ring the last stage receives, in its order (f32 pairs)."""
    r = [(_F(x), _F(y)) for x, y in np.asarray(ring, np.float32)]
    for dist in _stream_dists(other):
        r = _stream_stage(r, dist)
    return r


def _shoelace(ring):
    """(half the f64 shoelace sum, its x and y moments) of a ring of f32
    pairs, terms (0, 1), ..., (n - 1, 0) added in that order."""
    a2 = sx = sy = 0.0
    for k, (x0, y0) in enumerate(ring):
        x1, y1 = ring[(k + 1) % len(ring)]
        x0, y0, x1, y1 = float(x0), float(y0), float(x1), float(y1)
        cr = x0 * y1 - x1 * y0
        a2 += cr
        sx += (x0 + x1) * cr
        sy += (y0 + y1) * cr
    return 0.5 * a2, sx, sy


def clip_stream_model(polys, others):
    """Stage 2 of ``csrc/clip.cu`` in numpy scalars, one pair at a time in
    the kernel's order (``np.float32`` for each f32 operation, Python
    floats for the f64 shoelace): polys (B, V0, 2) with rects (B, 4) or
    clip rings (B, Vc, 2) -> (areas (B,), centroids (B, 2)) f32, bit for
    bit the kernel's.  A test oracle."""
    polys = np.asarray(polys, np.float32)
    others = np.asarray(others, np.float32)
    areas = np.zeros(len(polys), np.float32)
    cents = np.zeros((len(polys), 2), np.float32)
    with np.errstate(all="ignore"):
        for b in range(len(polys)):
            ring = _stream_ring(polys[b], others[b])
            a, sx, sy = _shoelace(ring)
            areas[b] = a
            if a != 0.0:
                cents[b] = (sx / (6.0 * a), sy / (6.0 * a))
            elif ring:
                cents[b] = ring[0]
    return areas, cents


def _pad_ring(ring: np.ndarray, slots, what: str) -> np.ndarray:
    """Pad (B, V, 2) rings to the next slot count in ``slots`` by repeating
    their last vertex (a zero-length edge adds nothing)."""
    v = next((k for k in slots if ring.shape[1] <= k), None)
    if v is None:
        raise ValueError(f"the clip kernels take at most {slots[-1]} "
                         f"{what}, got {ring.shape[1]}")
    if ring.shape[1] < v:
        pad = np.repeat(ring[:, -1:, :], v - ring.shape[1], axis=1)
        ring = np.concatenate([ring, pad], axis=1)
    return ring


def recentre_pairs(subj: np.ndarray, rect: np.ndarray):
    """Kernel inputs for world-coordinate pairs, as
    ``icebin_tpu/grid/exchange.py:557-562`` makes them: each pair is
    recentred on its rectangle in f64 and then cast to f32, so in-kernel
    coordinates are O(cell size); rings pad to the next ``KERNEL_V0``.
    Returns (polys (B, V0, 2) f32, rects (B, 4) f32, centres (B, 2) f64)."""
    subj = _pad_ring(np.asarray(subj, np.float64), KERNEL_V0,
                     "subject vertices (use subdiv <= 4)")
    rect = np.asarray(rect, np.float64)
    c = 0.5 * (rect[:, 0:2] + rect[:, 2:4])
    polys = (subj - c[:, None, :]).astype(np.float32)
    rects = (rect - np.concatenate([c, c], axis=1)).astype(np.float32)
    return polys, rects, c


def recentre_poly_pairs(subj: np.ndarray, clip: np.ndarray):
    """Convex-clip kernel inputs for world-coordinate pairs, as
    ``icebin_tpu/grid/exchange.py:416-421`` makes them: each pair is
    recentred in f64 on the mean of its clip ring's vertex slots and then
    cast to f32; rings pad to the next ``KERNEL_V0`` / ``KERNEL_VC``.
    Returns (polys (B, V0, 2) f32, clips (B, Vc, 2) f32, centres (B, 2)
    f64)."""
    subj = np.asarray(subj, np.float64)
    clip = np.asarray(clip, np.float64)
    c = clip.mean(axis=1)
    polys = _pad_ring(subj - c[:, None, :], KERNEL_V0,
                      "subject vertices (use subdiv <= 4)")
    clips = _pad_ring(clip - c[:, None, :], KERNEL_VC, "clip vertices")
    return polys.astype(np.float32), clips.astype(np.float32), c


def _make_engine(recentre, kernel, device, chunk: int):
    device = torch.device(device)

    def fn(subj: np.ndarray, other: np.ndarray):
        polys, others, c = recentre(subj, other)
        B = polys.shape[0]
        areas = np.empty(B, np.float64)
        cents = np.empty((B, 2), np.float64)
        for s in range(0, B, chunk):
            e = min(s + chunk, B)
            a, ctr = kernel(torch.as_tensor(polys[s:e], device=device),
                            torch.as_tensor(others[s:e], device=device))
            areas[s:e] = np.abs(a.cpu().numpy().astype(np.float64))
            cents[s:e] = ctr.cpu().numpy().astype(np.float64) + c[s:e]
        return areas, cents

    return fn


def make_clip_engine(*, device, chunk: int = 1 << 18):
    """Returns fn(subj (B, V0, 2), rect (B, 4)) -> (areas, centroids), numpy
    f64 in world coordinates: |area| per pair and its centroid.  Pairs are
    recentred by ``recentre_pairs`` and clipped on ``device`` in chunks."""
    return _make_engine(recentre_pairs, clip_areas_centroids, device, chunk)


def make_polyclip_engine(*, device, chunk: int = 1 << 18):
    """Returns fn(subj (B, V0, 2), clip (B, Vc, 2)) -> (areas, centroids),
    numpy f64 in world coordinates, for CONVEX CCW clip rings: |area| per
    pair and its centroid.  Pairs are recentred by ``recentre_poly_pairs``
    (V0 <= 16, Vc <= 8, as the reference's Pallas engine takes them) and
    clipped on ``device`` in chunks."""
    return _make_engine(recentre_poly_pairs, clip_areas_centroids_poly,
                        device, chunk)
