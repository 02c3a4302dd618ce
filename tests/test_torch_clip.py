"""Port's exchange-grid clip (icebin_tpu_torch.ops.clip, grid.exchange) vs
the reference's Pallas clip kernel (interpret mode on the CPU), the f64
oracle (icebin_tpu.oracle.clip) and the shared numpy exchange builder, on
the same seeded inputs.

Tolerances: the port's clip and the Pallas kernel both run in f32 on
recentred O(1) rings, so areas agree with the f64 oracle to ~1e-6 of the
ring's scale (2e-5 absolute, the reference suite's own bound in
tests/test_clip.py); centroids of slivers divide by 6*area and amplify f32
noise, so they are compared where the area is meaningful.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from icebin_tpu.grid.exchange import make_exchange_grid as shared_build
from icebin_tpu.grid.spec import GridSpecGeneric, GridSpecLonLat
from icebin_tpu.oracle.clip import (clip_polys_rects, polygon_areas,
                                    polygon_centroids)
from icebin_tpu.ops.pallas_clip import clip_areas_centroids_pallas

from icebin_tpu_torch.grid import (clip_pairs, make_exchange_grid,
                                   make_exchange_grid_host)
from icebin_tpu_torch.ops.clip import (clip_areas_centroids,
                                       clip_areas_centroids_ref,
                                       make_clip_engine)

from helpers import toy_grids

# the suite runs in parallel worker processes: one intra-op thread each
# keeps torch from contending with the other workers for the cores
torch.set_num_threads(1)

CPU = torch.device("cpu")
AREA_ATOL = 2e-5
CENT_ATOL = 1e-3


def pad_poly(pts, V):
    pts = np.asarray(pts, dtype=np.float64)
    return np.concatenate([pts, np.repeat(pts[-1:], V - len(pts), axis=0)])


def random_rings(B, V, seed):
    """Random convex rings around the origin plus centred rectangles."""
    rng = np.random.default_rng(seed)
    polys = np.zeros((B, V, 2))
    for b in range(B):
        n = rng.integers(3, V)
        ang = np.sort(rng.uniform(0, 2 * np.pi, n))
        r = rng.uniform(0.2, 1.5)
        polys[b] = pad_poly(np.stack([r * np.cos(ang), r * np.sin(ang)], -1),
                            V)
    h = rng.uniform(0.1, 1.0, (B, 2))
    rects = np.stack([-h[:, 0], -h[:, 1], h[:, 0], h[:, 1]], -1)
    return polys, rects


def pallas_clip(polys, rects):
    """The reference kernel in interpret mode; it takes batches of 128
    pairs, so pad with empty rings as its engine wrapper does."""
    B = len(polys)
    n = -(-B // 128) * 128 - B
    polys = np.concatenate([polys, np.zeros((n,) + polys.shape[1:])])
    rects = np.concatenate([rects, np.tile([[-1.0, -1.0, 1.0, 1.0]], (n, 1))])
    a, c = clip_areas_centroids_pallas(jnp.asarray(polys, jnp.float32),
                                       jnp.asarray(rects, jnp.float32))
    return np.asarray(a)[:B], np.asarray(c)[:B]


def port_clip(polys, rects):
    a, c = clip_areas_centroids(torch.as_tensor(polys, dtype=torch.float32),
                                torch.as_tensor(rects, dtype=torch.float32))
    return a.numpy().astype(np.float64), c.numpy().astype(np.float64)


@pytest.mark.parametrize("V", [8, 16])
def test_clip_matches_pallas_kernel_and_oracle(V):
    polys, rects = random_rings(256, V, seed=V)
    a, c = port_clip(polys, rects)
    a_o = polygon_areas(clip_polys_rects(polys, rects))
    c_o = polygon_centroids(clip_polys_rects(polys, rects))
    a_p, c_p = pallas_clip(polys, rects)
    np.testing.assert_allclose(a, a_o, atol=AREA_ATOL)
    np.testing.assert_allclose(a, a_p, atol=AREA_ATOL)
    nz = np.abs(a_o) > 1e-4
    np.testing.assert_allclose(c[nz], c_o[nz], atol=CENT_ATOL)
    np.testing.assert_allclose(c[nz], c_p[nz], atol=CENT_ATOL)


def test_nonconvex_subject():
    """L-shaped subject (non-convex) against centred boxes: the kernel's
    ring bound of 16 * V0 slots holds for it (reference
    tests/test_clip.py::test_nonconvex_polygon, recentred)."""
    L = np.array([[0, 0], [2, 0], [2, 1], [1, 1], [1, 2], [0, 2]], float)
    boxes = [((0, 0, 2, 2), 3.0), ((0, 0, 2, 0.5), 1.0),
             ((0.5, 0.5, 2, 2), 1.25), ((0.5, 1.2, 1.5, 1.8), 0.3)]
    polys, rects, want = [], [], []
    for (x0, y0, x1, y1), area in boxes:
        c = np.array([(x0 + x1) / 2, (y0 + y1) / 2])
        polys.append(pad_poly(L - c, 16))
        h = np.array([(x1 - x0) / 2, (y1 - y0) / 2])
        rects.append([-h[0], -h[1], h[0], h[1]])
        want.append(area)
    polys, rects = np.array(polys), np.array(rects)
    a, c = port_clip(polys, rects)
    np.testing.assert_allclose(a, want, atol=1e-6)      # f32 of O(1) areas
    c_o = polygon_centroids(clip_polys_rects(polys, rects))
    np.testing.assert_allclose(c, c_o, atol=1e-6)
    np.testing.assert_allclose(a, pallas_clip(polys, rects)[0], atol=1e-6)


def test_clip_engine_world_coordinates():
    """make_clip_engine recentres in f64 and casts to f32, so metre-scale
    world coordinates keep ~1e-7 relative accuracy; 5- and 12-vertex rings
    pad up to the kernel's 8 and 16 slots."""
    fn = make_clip_engine(device=CPU)
    for V, seed in ((5, 1), (12, 2)):
        polys, rects = random_rings(128, V, seed)
        off = np.array([-4.2e5, -2.9e6])          # SeaRISE-like offsets
        scale = 5e3
        polys_w = polys * scale + off
        rects_w = rects * scale + np.concatenate([off, off])
        a, c = fn(polys_w, rects_w)
        a_o = np.abs(polygon_areas(clip_polys_rects(polys_w, rects_w)))
        c_o = polygon_centroids(clip_polys_rects(polys_w, rects_w))
        np.testing.assert_allclose(a, a_o, atol=AREA_ATOL * scale ** 2)
        nz = a_o > 1e-4 * scale ** 2
        np.testing.assert_allclose(c[nz], c_o[nz], atol=CENT_ATOL * scale)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    polys, rects = random_rings(8, 8, seed=0)
    p = torch.as_tensor(polys, dtype=torch.float32)
    r = torch.as_tensor(rects, dtype=torch.float32)
    with pytest.raises(ValueError):
        clip_areas_centroids(p.double(), r.double())      # f64
    with pytest.raises(ValueError):
        clip_areas_centroids(p[:, :6], r)                  # V0 = 6
    with pytest.raises(ValueError):
        clip_areas_centroids(p, r[:4])                     # batch mismatch
    a, c = clip_areas_centroids(p, r)
    a_r, c_r = clip_areas_centroids_ref(p, r)
    assert torch.equal(a, a_r) and torch.equal(c, c_r)
    with pytest.raises(ValueError):
        make_clip_engine(device=CPU)(np.zeros((2, 20, 2)), np.zeros((2, 4)))


def test_exchange_grid_matches_shared_numpy_builder():
    """End to end on toy_grids: same overlap pairs, areas within f32 noise
    of the f64 builder, column sums exact after the f64 repair."""
    specA, specI = toy_grids(nI=(40, 40), nA=(8, 10))
    xg = make_exchange_grid(specA, specI, subdiv=1, device=CPU)
    xo = shared_build(specA, specI, subdiv=1, engine="numpy")
    np.testing.assert_array_equal(xg.iA, xo.iA)
    np.testing.assert_array_equal(xg.iI, xo.iI)
    # recentred f32 clip: ~1e-7 of the ice cell's area per overlap
    areasI = specI.cell_areas()[xo.iI]
    assert np.max(np.abs(xg.area - xo.area) / areasI) < 1e-6
    np.testing.assert_allclose(xg.area_sums_I(), specI.cell_areas(),
                               rtol=1e-12)


def test_host_build_and_clip_pairs_are_the_shared_stages():
    """make_exchange_grid_host is the shared f64 numpy build, and clip_pairs
    hands the clip the shared candidate pairs with their rings and ice
    rectangles."""
    from icebin_tpu.grid import exchange as shared
    specA, specI = toy_grids(nI=(24, 24), nA=(6, 8))
    xh = make_exchange_grid_host(specA, specI, subdiv=1)
    xo = shared_build(specA, specI, subdiv=1, engine="numpy")
    for k in ("iA", "iI", "area"):
        np.testing.assert_array_equal(getattr(xh, k), getattr(xo, k))
    pairA, pairI, subj, rect = clip_pairs(specA, specI, subdiv=1)
    polysA, keepA = shared.prepare_subject_polygons(specA, specI, subdiv=1)
    wantA, wantI = shared.candidate_pairs(specA, specI, polysA, keepA)
    np.testing.assert_array_equal(pairA, wantA)
    np.testing.assert_array_equal(pairI, wantI)
    np.testing.assert_array_equal(subj, polysA[wantA])
    np.testing.assert_array_equal(rect, specI.cell_rects()[wantI])


def test_exchange_dispatch():
    """Separable pairs delegate to the shared exact builders; generic-polygon
    ice grids need the convex-clip kernel, which is not ported yet."""
    specA = GridSpecLonLat(lonb=np.linspace(0, 40, 5),
                           latb=np.linspace(30, 80, 6))
    specB = GridSpecLonLat(lonb=np.linspace(0, 40, 9),
                           latb=np.linspace(30, 80, 11))
    xg = make_exchange_grid(specA, specB, device=CPU)
    xo = shared_build(specA, specB, engine="numpy")
    np.testing.assert_array_equal(xg.iI, xo.iI)
    np.testing.assert_array_equal(xg.area, xo.area)
    gen = GridSpecGeneric(polygons=np.array([[[0, 30], [10, 30], [10, 40],
                                              [0, 40]]], float))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_exchange_grid(specA, gen, device=CPU)
