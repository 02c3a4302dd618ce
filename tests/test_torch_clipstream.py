"""The stage-2 clip's bit model (icebin_tpu_torch.ops.clip.clip_stream_model:
csrc/clip.cu's register pipeline in numpy scalars) against the reference's
clip kernels (Pallas interpret mode on the CPU) and the f64 oracle
(icebin_tpu.oracle.clip), on the seeded cases of tests/test_torch_cuda.py
(``clip_cases``: random convex rings, combs, an L-shaped ring, rings wholly
inside and outside, a ring around the clip, collinear and point rings, an
edge shared, clip rings with zero-length and duplicate-padded edges).  The
card's tests hold every stage-2 instance to the model bit for bit.

Tolerances (those of tests/test_torch_clip.py and test_torch_polyclip.py):
the model and the reference kernels run in f32 on recentred O(1) rings, so
areas agree with the f64 oracle to 2e-5 absolute; centroids of slivers
divide by 6*area, so they are compared (to 1e-3) where the oracle's area
exceeds 1e-4.  The reference's kernels sum their shoelace in f32 over
forward-filled slots (contracted into FMAs on the CPU), which leaves them
off the oracle by up to 1.2e-4 in area on some of these pairs (and its
centroids by more than 1e-3); against them the model is held to 2e-5 in
area and 1e-3 in centroid beyond each pair's reference error.  The reference's
convex clip runs as its Pallas kernel in interpret mode at 4 clip slots;
at 8 it is its XLA twin (``icebin_tpu.ops.clip.clip_areas_centroids_poly``),
as tests/test_torch_polyclip.py explains (the Pallas kernel at 8 slots
compiles for 20-31 s a shape and starved the suite's mesh tests).  The
model's ring is the stage-1 kernel's ring rotated, exactly, and their f64
shoelace sums agree to the rounding of a sum of n terms.
"""
import functools
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icebin_tpu.ops.clip import clip_areas_centroids_poly as ref_xla
from icebin_tpu.ops.pallas_clip import (clip_areas_centroids_pallas,
                                        clip_areas_centroids_poly_pallas)
from icebin_tpu.oracle.clip import (clip_polys_polys, clip_polys_rects,
                                    polygon_areas, polygon_centroids)

from icebin_tpu_torch.ops import clip as cl
from test_torch_cuda import clip_cases

torch.set_num_threads(1)

AREA_ATOL = 2e-5
CENT_ATOL = 1e-3
F = np.float32


def slots(Vc):
    return 4 if Vc <= 4 else 8


@functools.lru_cache(maxsize=None)
def reference(V0, kc):
    """{Vc: (areas, centroids)} of the reference's clip on ``clip_cases``
    (52 random pairs and the 12 fixed ones each, 128 pairs a call: one
    tile of the Pallas kernels): the rectangle kernel for kc = 0, the
    convex kernel at kc = 4 (Pallas, x64 off as the reference's engine
    traces it) and its XLA twin at kc = 8."""
    vcs = [0] if kc == 0 else [v for v in (3, 4, 6, 8) if slots(v) == kc]
    cases = [clip_cases(V0, v, seed=3, B=52) for v in vcs]
    if kc == 0:
        cases.append(clip_cases(V0, 0, seed=4, B=52))
    P = jnp.asarray(np.concatenate([p for p, _ in cases]), jnp.float32)
    Q = jnp.asarray(np.concatenate([q for _, q in cases]), jnp.float32)
    if kc == 0:
        a, c = clip_areas_centroids_pallas(P, Q)
    elif kc == 4:
        with jax.enable_x64(False):
            a, c = clip_areas_centroids_poly_pallas(P, Q)
    else:
        a, c = ref_xla(P, Q)
    a, c = np.asarray(a), np.asarray(c)
    return {v: (a[64 * k:64 * (k + 1)], c[64 * k:64 * (k + 1)])
            for k, v in enumerate(vcs)}


def oracle(P, Q):
    rings = clip_polys_rects(P, Q) if Q.ndim == 2 else clip_polys_polys(P, Q)
    return polygon_areas(rings), polygon_centroids(rings)


@pytest.mark.parametrize("Vc", [0, 3, 4, 6, 8])
@pytest.mark.parametrize("V0", [8, 16])
def test_model_matches_reference_kernels_and_oracle(V0, Vc):
    P, Q = clip_cases(V0, Vc, seed=3, B=52)
    a, c = cl.clip_stream_model(P, Q)
    a_r, c_r = reference(V0, 0 if Vc == 0 else slots(Vc))[Vc]
    a_o, c_o = oracle(P.astype(np.float64), Q.astype(np.float64))
    np.testing.assert_allclose(a, a_o, atol=AREA_ATOL)
    # the reference's f32 shoelace over its forward-filled slots is itself
    # off the oracle (by 4.4e-5 and 1.2e-4 at V0 = 8 and 16 on the rings
    # wholly outside, 5 units away): the model is held to the reference
    # within 2e-5 beyond the reference's own error on each pair
    assert np.all(np.abs(a - a_r) <= AREA_ATOL + np.abs(a_r - a_o))
    nz = np.abs(a_o) > 1e-4
    np.testing.assert_allclose(c[nz], c_o[nz], atol=CENT_ATOL)
    assert np.all(np.abs(c - c_r)[nz]
                  <= CENT_ATOL + np.abs(c_r - c_o)[nz])


def compact_ring(ring, other):
    """The stage-1 kernel's ring: each pass emits the group of the edge
    (n - 1 -> 0) first, then those of (k - 1 -> k) for k = 1 .. n - 1; a
    zero-length clip edge skips its pass."""
    r = [(F(x), F(y)) for x, y in np.asarray(ring, np.float32)]
    for dist in cl._stream_dists(other):
        if dist is None or not r:
            continue
        ds = [dist(x, y) for x, y in r]
        out = []
        for k in range(len(r)):
            (xp, yp), dp = r[k - 1], ds[k - 1]
            (x, y), d = r[k], ds[k]
            if (d >= 0) != (dp >= 0):
                out.append(cl._crossing(xp, yp, dp, x, y, d))
            if d >= 0:
                out.append((x, y))
        r = out
    return r


@pytest.mark.parametrize("Vc", [0, 3, 4, 6, 8])
@pytest.mark.parametrize("V0", [8, 16])
def test_stream_ring_is_the_stage1_ring_rotated(V0, Vc):
    """The pipeline's ring is the stage-1 ring rotated (the same f32
    vertices in the same cyclic order), so their shoelace sums hold the
    same terms and agree within the rounding of an f64 sum."""
    P, Q = clip_cases(V0, Vc, seed=5)
    with np.errstate(all="ignore"):
        for p, q in zip(P, Q):
            s, k = cl._stream_ring(p, q), compact_ring(p, q)
            assert len(s) == len(k)
            assert not s or any(s == k[j:] + k[:j] for j in range(len(k)))
            a_s, a_k = cl._shoelace(s)[0], cl._shoelace(k)[0]
            terms = sum(abs(float(x0) * float(y1) - float(x1) * float(y0))
                        for (x0, y0), (x1, y1) in zip(k, k[1:] + k[:1]))
            assert abs(a_s - a_k) <= len(k) * 2.0 ** -52 * terms


@pytest.mark.parametrize("V0", [8, 16])
def test_zero_length_clip_edge_passes_the_ring_through(V0):
    """A duplicate clip vertex (a zero-length edge) anywhere in the ring
    gives the result of the ring without it, bit for bit."""
    P, Q = clip_cases(V0, 8, seed=6)
    ring = Q[:, :6]                       # ring of 6 (the cases' Vc = 8)
    for j in (0, 2, 5):
        dup = np.concatenate([ring[:, :j + 1], ring[:, j:]], axis=1)
        pad = np.concatenate([dup, dup[:, -1:]], axis=1)
        for other in (dup, pad):
            a, c = cl.clip_stream_model(P, other)
            a6, c6 = cl.clip_stream_model(P, ring)
            assert np.array_equal(a.view(np.int32), a6.view(np.int32))
            assert np.array_equal(c.view(np.int32), c6.view(np.int32))


@pytest.mark.parametrize("Vc", [0, 4])
def test_degenerate_rings_take_their_first_vertex(Vc):
    """Zero-area results: the centroid is the first vertex the last stage
    received, (0, 0) if it received none (wholly outside)."""
    P, Q = clip_cases(8, Vc, seed=7)
    a, c = cl.clip_stream_model(P, Q)
    zero = np.flatnonzero(a == 0)
    assert len(zero) >= 5                 # outside x2, collinear, point, edge
    for b in zero:
        ring = cl._stream_ring(P[b], Q[b])
        want = ring[0] if ring else (F(0), F(0))
        assert tuple(c[b]) == tuple(want)
    for b in (-7, -6):                    # wholly outside
        assert not cl._stream_ring(P[b], Q[b])
        assert a[b] == 0 and tuple(c[b]) == (0.0, 0.0)


def test_fma32_rounds_once():
    """The model's FMA (the crossing point) is the exactly rounded
    a * b + c, also where the f64 sum lands on an f32 halfway point."""
    rng = np.random.default_rng(0)

    def exact(a, b, c):
        v = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
        r = F(float(v))
        cands = [np.nextafter(r, F(-np.inf)), r, np.nextafter(r, F(np.inf))]
        return min(cands, key=lambda x: (abs(Fraction(float(x)) - v),
                                         int(x.view(np.int32)) & 1))

    traps = [(F(2 ** -12 * (1 + 2 ** -23)), F(2 ** -12 * (1 - 2 ** -23)),
              F(1 + 2 ** -23)),
             (F(2 ** -12 * (1 + 2 ** -23)), F(2 ** -12 * (1 + 2 ** -23)),
              F(1.0))]
    for _ in range(3000):
        a = F(rng.normal() * 10.0 ** rng.integers(-3, 4))
        b = F(rng.normal())
        traps.append((a, b, F(-float(F(float(a) * float(b))))))
        traps.append((a, b, F(rng.normal() * 10.0 ** rng.integers(-3, 4))))
    for a, b, c in traps:
        assert cl._fma32(a, b, c) == exact(a, b, c), (a, b, c)
    assert cl._fma32(*traps[0]) != F(float(traps[0][0]) * float(traps[0][1])
                                     + float(traps[0][2]))


def test_compact_wrappers_and_geometry_entry_on_the_cpu():
    """On CPU tensors the stage-1 wrappers run the plain versions (and
    count nothing); the explicit-geometry entry launches only on the card,
    and every wrapper refuses what the kernels do not take."""
    P, Q = clip_cases(8, 0, seed=8)
    p, q = torch.as_tensor(P), torch.as_tensor(Q)
    n = cl.clip_areas_centroids_compact.launches
    a, c = cl.clip_areas_centroids_compact(p, q)
    a_r, c_r = cl.clip_areas_centroids_ref(p, q)
    assert torch.equal(a, a_r) and torch.equal(c, c_r)
    assert cl.clip_areas_centroids_compact.launches == n
    P4, Q4 = clip_cases(8, 4, seed=8)
    p4, q4 = torch.as_tensor(P4), torch.as_tensor(Q4)
    a, _ = cl.clip_areas_centroids_poly_compact(p4, q4)
    assert torch.equal(a, cl.clip_areas_centroids_poly_ref(p4, q4)[0])
    with pytest.raises(ValueError):
        cl.clip_stream_at(p, q, 128, 1, "vector")        # a CPU tensor
    with pytest.raises(ValueError):
        cl.clip_areas_centroids_compact(p[:, :6], q)      # V0 = 6
    with pytest.raises(ValueError):
        cl.clip_areas_centroids_poly_compact(p4, q4[:, :3])   # Vc = 3
