"""Port's generic-polygon exchange build (icebin_tpu_torch.ops.clip's convex
clip, grid.exchange's polyclip stages, cli.overlap) vs the reference's
convex clip (its Pallas kernel in interpret mode on the CPU, and its XLA
twin), the f64 oracle (icebin_tpu.oracle.clip), the reference's exchange
builder and the reference CLI, on the same seeded inputs (each package
builds its own grid classes from the same numbers).

The Pallas kernel runs here at 4 clip slots only.  At 8 it compiles for
20-31 s per shape and runs 3-8 s per 128-pair tile on about four cores;
beside it, under the suite's parallel workers, the 8-device mesh tests of
other workers starve until XLA's all-reduce rendezvous aborts them (40 s),
and a crashed worker can hang the whole run.  At 8 slots the reference is
therefore its XLA twin (``icebin_tpu.ops.clip.clip_areas_centroids_poly``,
the data flow the Pallas kernel implements and the plain version ports)
and, for exchange grids, the shared builder's ``jax`` engine;
tests/test_grid_generality.py:356 holds the Pallas kernel itself at 8
slots against the f64 oracle, which the port is held to here too.

Tolerances: the port's plain convex clip and the reference kernels run in
f32 on recentred O(1) rings, so areas agree with the f64 oracle to ~1e-6 of
the ring's scale (2e-5 absolute, as tests/test_torch_clip.py holds the
rectangle clip); centroids of slivers divide by 6*area, so they are
compared where the area is meaningful.  Exchange grids are held to the
reference tests' own bounds (tests/test_grid_generality.py): f32 noise
flips sliver overlaps across the min-area cut, so measures are compared
(column sums rtol 2e-4, totals rtol 2e-5), not the nnz pattern.

The reference's f32 kernels are themselves off the f64 oracle by up to
5.3e-5 at V0 = 16, Vc = 8 (4096 ring slots): XLA on the CPU contracts the
shoelace's x * yn - xn * y into an FMA, so a duplicate slot adds the
rounding residue of its product instead of an exact 0 (the same ring with
an f64 or an uncontracted f32 shoelace is within 3e-7).  Against them the
port is held to 1e-4 at that shape and to 2e-5 elsewhere; against the
oracle to 2e-5 everywhere.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icebin_tpu.cli.overlap import main as ref_overlap
from icebin_tpu.grid import proj as ref_proj, spec as ref_spec
from icebin_tpu.grid.exchange import make_exchange_grid as shared_build
from icebin_tpu.grid.proj import PlateCarree
from icebin_tpu.grid.spec import Grid, GridSpecLonLat, GridSpecXY
from icebin_tpu.io.ncio import read_exchange, write_grid
from icebin_tpu.ops.clip import clip_areas_centroids_poly as ref_xla
from icebin_tpu.oracle.clip import (clip_polys_polys, polygon_areas,
                                    polygon_centroids)
from icebin_tpu.ops.pallas_clip import clip_areas_centroids_poly_pallas

from icebin_tpu_torch.cli.overlap import main as port_overlap
from icebin_tpu_torch.grid import (assemble_polyclip, clip_poly_host,
                                   make_exchange_grid, polyclip_pairs)
from icebin_tpu_torch.grid import proj as port_proj, spec as port_spec
from icebin_tpu_torch.ops.clip import (clip_areas_centroids_poly,
                                       clip_areas_centroids_poly_ref,
                                       make_polyclip_engine)

# the suite runs in parallel worker processes: one intra-op thread each
# keeps torch from contending with the other workers for the cores
torch.set_num_threads(1)

CPU = torch.device("cpu")
AREA_ATOL = 2e-5
CENT_ATOL = 1e-3
COLSUM_RTOL = 2e-4
TOTAL_RTOL = 2e-5


def pad_ring(ring, V):
    ring = np.asarray(ring, np.float64)
    return np.concatenate([ring, np.repeat(ring[-1:], V - len(ring), 0)])


def convex_ring(rng, n, r0, r1):
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    r = rng.uniform(r0, r1)
    return (np.stack([r * np.cos(ang), r * np.sin(ang)], -1)
            + rng.uniform(-0.3, 0.3, 2))


def comb_ring(rng, V):
    """A comb of V // 4 teeth (non-convex, V vertices), rotated and scaled
    at random: each clip edge crosses every tooth."""
    h = V // 2
    t = np.linspace(-1.0, 1.0, h)
    top = np.stack([t, np.where(np.arange(h) % 2, 1.2, -0.2)], -1)
    ring = np.concatenate([np.stack([t[::-1], np.full(h, -1.3)], -1), top])
    th = rng.uniform(0, 2 * np.pi)
    rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    return ring @ rot.T * rng.uniform(0.6, 1.4)


def pairs(V0, Vc, B=64, seed=0):
    """B subject rings (half random convex with 3..V0 vertices, half combs)
    x B convex CCW clip rings of exactly Vc vertices, padded to the
    kernel's slot counts."""
    rng = np.random.default_rng(seed + 100 * V0 + Vc)
    kc = 4 if Vc <= 4 else 8
    subj = [pad_ring(convex_ring(rng, rng.integers(3, V0 + 1), 0.2, 1.5), V0)
            for _ in range(B // 2)]
    subj += [comb_ring(rng, V0) for _ in range(B - B // 2)]
    clip = [pad_ring(convex_ring(rng, Vc, 0.5, 1.2), kc) for _ in range(B)]
    return np.array(subj), np.array(clip)


@functools.lru_cache(maxsize=None)
def reference_results(V0, kc):
    """The reference's convex clip on the two cases of one kernel shape at
    once (2 x 64 pairs, one tile of the Pallas kernel): the Pallas kernel
    in interpret mode at kc = 4 clip slots, traced with x64 off as the
    reference's engine traces it, and its XLA twin in f32 at kc = 8."""
    cases = [Vc for Vc in (3, 4, 6, 8) if (4 if Vc <= 4 else 8) == kc]
    P, Q = zip(*(pairs(V0, Vc) for Vc in cases))
    P = jnp.asarray(np.concatenate(P), jnp.float32)
    Q = jnp.asarray(np.concatenate(Q), jnp.float32)
    if kc == 4:
        with jax.enable_x64(False):
            a, c = clip_areas_centroids_poly_pallas(P, Q)
    else:
        a, c = ref_xla(P, Q)
    a, c = np.asarray(a), np.asarray(c)
    return {Vc: (a[64 * k:64 * (k + 1)], c[64 * k:64 * (k + 1)])
            for k, Vc in enumerate(cases)}


@pytest.mark.parametrize("Vc", [3, 4, 6, 8])
@pytest.mark.parametrize("V0", [8, 16])
def test_convex_clip_matches_reference_and_oracle(V0, Vc):
    P, Q = pairs(V0, Vc)
    a, c = clip_areas_centroids_poly(torch.as_tensor(P, dtype=torch.float32),
                                     torch.as_tensor(Q, dtype=torch.float32))
    a, c = a.numpy().astype(np.float64), c.numpy().astype(np.float64)
    rings = clip_polys_polys(P, Q)
    a_o, c_o = polygon_areas(rings), polygon_centroids(rings)
    a_r, c_r = reference_results(V0, Q.shape[1])[Vc]
    np.testing.assert_allclose(a, a_o, atol=AREA_ATOL)
    slots = V0 * 2 ** Q.shape[1]
    np.testing.assert_allclose(a, a_r,
                               atol=AREA_ATOL if slots < 4096 else 1e-4)
    nz = np.abs(a_o) > 1e-4
    assert nz.sum() > len(a) // 2          # the clips cut, not miss
    np.testing.assert_allclose(c[nz], c_o[nz], atol=CENT_ATOL)
    np.testing.assert_allclose(c[nz], c_r[nz], atol=CENT_ATOL)


def test_polyclip_engine_world_coordinates():
    """make_polyclip_engine recentres in f64 on the clip ring and casts to
    f32, so metre-scale world coordinates keep ~1e-7 relative accuracy;
    5- and 12-vertex subjects and 3- and 6-vertex clips pad up to the
    kernel's slots.  The reference's pad-pair invariant
    (icebin_tpu/ops/clip.py:217-221) holds: an all-zero clip ring is a
    no-op pass, and an all-zero subject has zero area."""
    fn = make_polyclip_engine(device=CPU)
    off = np.array([-4.2e5, -2.9e6])               # SeaRISE-like offsets
    scale = 5e3
    for V0, Vc in ((5, 3), (12, 6)):
        P, Q = pairs(16, Vc, B=96, seed=V0)
        P, Q = P[:, :V0] * scale + off, Q[:, :Vc] * scale + off
        a, c = fn(P, Q)
        a_o, c_o = clip_poly_host(P, Q)
        np.testing.assert_allclose(a, a_o, atol=AREA_ATOL * scale ** 2)
        nz = a_o > 1e-4 * scale ** 2
        np.testing.assert_allclose(c[nz], c_o[nz], atol=CENT_ATOL * scale)
    P, _ = pairs(8, 4, B=2)
    a, _ = fn(np.concatenate([P, np.zeros((1, 8, 2))]), np.zeros((3, 4, 2)))
    np.testing.assert_allclose(a[:2], np.abs(polygon_areas(P)), rtol=1e-6)
    assert a[2] == 0.0
    with pytest.raises(ValueError):
        fn(np.zeros((2, 20, 2)), np.zeros((2, 4, 2)))       # V0 > 16
    with pytest.raises(ValueError):
        fn(np.zeros((2, 8, 2)), np.zeros((2, 9, 2)))        # Vc > 8


def test_convex_clip_wrapper_rejects_what_the_kernel_does_not_take():
    P, Q = pairs(8, 4, B=8)
    p = torch.as_tensor(P, dtype=torch.float32)
    q = torch.as_tensor(Q, dtype=torch.float32)
    with pytest.raises(ValueError):
        clip_areas_centroids_poly(p.double(), q.double())     # f64
    with pytest.raises(ValueError):
        clip_areas_centroids_poly(p[:, :6], q)                 # V0 = 6
    with pytest.raises(ValueError):
        clip_areas_centroids_poly(p, q[:, :3])                 # Vc = 3
    with pytest.raises(ValueError):
        clip_areas_centroids_poly(p, q[:4])                    # batch
    a, c = clip_areas_centroids_poly(p, q)
    a_r, c_r = clip_areas_centroids_poly_ref(p, q)
    assert torch.equal(a, a_r) and torch.equal(c, c_r)


# -- exchange grids: every generic case of tests/test_grid_generality.py ----

def _hex_polygons(centers, r):
    """(n, 6, 2) hexagon rings (degrees) around lon/lat centers."""
    ang = np.radians(np.arange(6) * 60.0 + 15.0)
    return np.stack([centers[:, None, 0] + r * np.cos(ang)[None, :],
                     centers[:, None, 1] + r * np.sin(ang)[None, :]], -1)


def _tri_grid(x0, x1, y0, y1, n):
    """2n^2 triangles tiling [x0,x1]x[y0,y1] (lon/lat degrees)."""
    xs = np.linspace(x0, x1, n + 1)
    ys = np.linspace(y0, y1, n + 1)
    tris = []
    for j in range(n):
        for i in range(n):
            a, b, c, d = xs[i], xs[i + 1], ys[j], ys[j + 1]
            tris.append([[a, c], [b, c], [b, d]])
            tris.append([[a, c], [b, d], [a, d]])
    return np.asarray(tris)


def _centers(x0, x1, y0, y1, step):
    return np.stack(np.meshgrid(np.arange(x0, x1, step),
                                np.arange(y0, y1, step)),
                    axis=-1).reshape(-1, 2)


def case(name, port=False):
    """(specA, specI, subdiv, repair) of the generic case ``name``, built as
    the reference test at the cited line builds it, from the reference's
    classes or (``port``) from the port's own, out of the same numbers."""
    S, P = (port_spec, port_proj) if port else (ref_spec, ref_proj)
    pc = P.PlateCarree
    if name == "generic_x_xy":                     # :172
        rng = np.random.default_rng(3)
        c = _centers(9.0, 31.0, 43.0, 67.0, 3.2)
        c = c + rng.uniform(-0.3, 0.3, c.shape)
        return (S.GridSpecGeneric(polygons=_hex_polygons(c, r=1.2)),
                S.GridSpecXY(xb=np.linspace(0.0, 40.0 * 25e3, 65),
                           yb=np.linspace(30.0 * 25e3, 80.0 * 25e3, 81),
                           projection=pc(scale=25e3)), 2, False)
    if name == "triangles_x_xy":                   # :201
        return (S.GridSpecGeneric(polygons=_tri_grid(10.0, 22.0, 40.0, 52.0,
                                                   6)),
                S.GridSpecXY(xb=np.linspace(12.0 * 10e3, 20.0 * 10e3, 17),
                           yb=np.linspace(42.0 * 10e3, 50.0 * 10e3, 17),
                           projection=pc(scale=10e3)), 2, True)
    tris = S.GridSpecGeneric(polygons=_tri_grid(10.0, 22.0, 40.0, 52.0, 8))
    c = _centers(13.0, 19.1, 43.0, 49.1, 2.0)
    if name == "hex_clip":                         # :270 and :356
        return (tris, S.GridSpecGeneric(polygons=_hex_polygons(c, r=0.8),
                                      projection=pc(scale=10e3)), 2, False)
    if name == "quad_clip":                        # :295-302
        ang = np.radians([45.0, 135.0, 225.0, 315.0])
        quads = np.stack([c[:, None, 0] + 0.9 * np.cos(ang)[None, :],
                          c[:, None, 1] + 0.9 * np.sin(ang)[None, :]], -1)
        return (tris, S.GridSpecGeneric(polygons=quads,
                                      projection=pc(scale=10e3)), 2, False)
    if name == "concave":                          # :310
        L = [[0.0, 0.0], [3.0, 0.0], [3.0, 1.0], [1.0, 1.0], [1.0, 3.0],
             [0.0, 3.0]]
        arrow = [[5.0, 0.0], [7.0, 1.0], [9.0, 0.0], [7.0, 3.0],
                 [7.0, 3.0], [7.0, 3.0]]
        return (S.GridSpecGeneric(polygons=_tri_grid(-1.0, 10.0, -1.0, 4.0,
                                                   12)),
                S.GridSpecGeneric(polygons=np.asarray([L, arrow]),
                                projection=pc(scale=1e3)), 2, False)
    if name == "lonlat_x_generic":                 # :374
        return (S.GridSpecLonLat(lonb=np.linspace(0.0, 40.0, 11),
                               latb=np.linspace(35.0, 75.0, 11)),
                S.GridSpecGeneric(polygons=_hex_polygons(
                    _centers(12.0, 28.1, 45.0, 61.1, 3.0), r=1.0),
                    projection=pc(scale=25e3)), 4, True)
    if name == "pad_corner":                       # :391
        L = np.asarray([[[1.0, 3.0], [0.0, 3.0], [0.0, 0.0], [3.0, 0.0],
                         [3.0, 1.0], [1.0, 1.0], [1.0, 1.0], [1.0, 1.0]]])
        return (S.GridSpecGeneric(polygons=_tri_grid(-1.0, 4.0, -1.0, 4.0,
                                                   10)),
                S.GridSpecGeneric(polygons=L, projection=pc(scale=1e3)), 2,
                False)
    raise KeyError(name)


CLIP_CASES = ["hex_clip", "quad_clip", "concave", "lonlat_x_generic",
              "pad_corner"]
CASES = ["generic_x_xy", "triangles_x_xy"] + CLIP_CASES
#: cases whose Pallas kernels clip against rectangles or at 4 clip slots,
#: cheap in interpret mode (see the module docstring)
PALLAS_CASES = ["generic_x_xy", "triangles_x_xy", "quad_clip"]


@pytest.mark.parametrize("name", CASES)
def test_exchange_matches_shared_builder(name):
    """The port's make_exchange_grid on the CPU against the shared builder
    with the f64 numpy oracle, its XLA engine, and its Pallas kernels
    (interpret mode) where they clip at 4 slots or against rectangles:
    column sums and totals within the reference tests' bounds, and no
    duplicate (iA, iI) pair."""
    specA, specI, subdiv, repair = case(name)
    pA, pI, _, _ = case(name, port=True)
    xg = make_exchange_grid(pA, pI, subdiv=subdiv, device=CPU, repair=repair)
    key = xg.iA * np.int64(xg.nI) + xg.iI
    assert len(np.unique(key)) == len(key)
    cell = (specI.cell_areas() if isinstance(specI, GridSpecXY)
            else np.abs(specI.plane_areas()))
    # partly covered columns keep the f32 noise of their overlaps: ~1e-7 of
    # the cell per overlap for the port (1e-6 bounds it, as
    # test_torch_clip.py holds the rectangle build; the XLA engine runs in
    # f64 under the suite's x64), up to 4.2e-6 for the Pallas kernels in
    # interpret mode (the FMA residue of the module docstring, which also
    # makes spurious slivers of disjoint pairs)
    engines = [("numpy", 1e-6), ("jax", 1e-6)]
    if name in PALLAS_CASES:
        engines.append(("pallas", 1e-5))
    for engine, noise in engines:
        xo = shared_build(specA, specI, subdiv=subdiv, engine=engine,
                          repair=repair)
        col, col_o = xg.area_sums_I(), xo.area_sums_I()
        assert np.all(np.abs(col - col_o)
                      <= COLSUM_RTOL * np.abs(col_o) + noise * cell)
        np.testing.assert_allclose(xg.area.sum(), xo.area.sum(),
                                   rtol=TOTAL_RTOL)
    if name in ("concave", "pad_corner"):
        # fully covered concave cells close to their exact plane areas
        want = [5.0e6, 4.0e6] if name == "concave" else [5.0e6]
        np.testing.assert_allclose(xg.area_sums_I(), want, rtol=AREA_ATOL)


@pytest.mark.parametrize("name", CLIP_CASES)
def test_polyclip_stages_are_the_reference_build(name):
    """polyclip_pairs + the f64 oracle clip + assemble_polyclip rebuild the
    reference's numpy builder's exchange grid bit for bit: the port's pairing
    and piece aggregation are the reference's."""
    specA, specI, subdiv, repair = case(name)
    pA, pI, _, _ = case(name, port=True)
    pairA, pairI, subj, clip, piece2cell = polyclip_pairs(pA, pI, subdiv)
    areas, cents = clip_poly_host(subj, clip)
    xg = assemble_polyclip(pairA, pairI, areas, cents, piece2cell, pA, pI,
                           repair=repair)
    xo = shared_build(specA, specI, subdiv=subdiv, engine="numpy",
                      repair=repair)
    for k in ("iA", "iI", "area", "centroid"):
        np.testing.assert_array_equal(getattr(xg, k), getattr(xo, k))


def test_masked_grids_match_shared_builder():
    """Masks on both grids (``Grid``s) reach the pairing as the shared
    builder applies them: no overlap of a masked cell, and the same
    measures as the f64 numpy build."""
    specA, specI, subdiv, _ = case("hex_clip")
    pA, pI, _, _ = case("hex_clip", port=True)
    rng = np.random.default_rng(5)
    gA = Grid(specA, mask=rng.uniform(size=specA.ncells) > 0.3)
    gI = Grid(specI, mask=rng.uniform(size=specI.ncells) > 0.3)
    xg = make_exchange_grid(port_spec.Grid(pA, mask=gA.mask),
                            port_spec.Grid(pI, mask=gI.mask), subdiv=subdiv,
                            device=CPU, repair=False)
    xo = shared_build(gA, gI, subdiv=subdiv, engine="numpy", repair=False)
    assert gA.mask[xg.iA].all() and gI.mask[xg.iI].all()
    np.testing.assert_array_equal(xg.iA, xo.iA)
    np.testing.assert_array_equal(xg.iI, xo.iI)
    cell = np.abs(specI.plane_areas())
    assert np.max(np.abs(xg.area - xo.area) / cell[xo.iI]) < 1e-6


@pytest.mark.parametrize("subject", ["lonlat", "generic"])
def test_overlap_cli_matches_reference_cli(tmp_path, subject, capsys):
    """The port's overlap CLI (--device cpu) against the reference's
    (--engine numpy) on a lat-lon x XY pair and a generic-subject x XY
    pair, in process: the same overlap pairs, areas within f32 noise of
    the cell, column sums exact after the repair."""
    if subject == "lonlat":
        specA = GridSpecLonLat(lonb=np.linspace(0.0, 40.0, 9),
                               latb=np.linspace(30.0, 80.0, 11))
        specI = GridSpecXY(xb=np.linspace(0.0, 40.0 * 25e3, 33),
                           yb=np.linspace(30.0 * 25e3, 80.0 * 25e3, 41),
                           projection=PlateCarree(scale=25e3))
    else:
        specA, specI, _, _ = case("generic_x_xy")
    a, i = str(tmp_path / "a.nc"), str(tmp_path / "i.nc")
    write_grid(a, specA)
    write_grid(i, specI)
    out_p, out_r = str(tmp_path / "port.nc"), str(tmp_path / "ref.nc")
    assert port_overlap([a, i, out_p, "--device", "cpu"]) == 0
    assert capsys.readouterr().out.startswith("overlap: ")
    assert ref_overlap([a, i, out_r, "--engine", "numpy"]) == 0
    xp, xr = read_exchange(out_p), read_exchange(out_r)
    np.testing.assert_array_equal(xp.iA, xr.iA)
    np.testing.assert_array_equal(xp.iI, xr.iI)
    cell = specI.cell_areas()
    assert np.max(np.abs(xp.area - xr.area) / cell[xr.iI]) < 1e-6
    full = np.abs(xr.area_sums_I() - cell) < 1e-12 * cell     # repaired
    assert full.sum() > 100
    np.testing.assert_allclose(xp.area_sums_I()[full], cell[full],
                               rtol=1e-12)


def test_overlap_cli_needs_a_gpu_unless_told_cpu(tmp_path):
    """--device cuda (the default) without a card exits non-zero."""
    if torch.cuda.is_available():
        return                  # the card is there: nothing to refuse
    with pytest.raises(SystemExit) as e:
        port_overlap([str(tmp_path / f) for f in ("a.nc", "i.nc", "x.nc")])
    assert e.value.code != 0
