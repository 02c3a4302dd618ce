"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU (sm_90a) and nvcc; without a card they skip.
This file imports no JAX, so on a machine without JAX run it without the
suite's conftest:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_cuda.py

Tolerances: the spmm kernels and their plain version both sum in f64 and
round once to f32, so they agree to one f32 ulp of the output; the clip
kernel sums its clipped ring's shoelace in f64 where the plain version
sums 16 * V0 slots in f32, so areas agree to 1e-5 of the ring's scale; the
convex-clip kernel likewise against V0 * 2**Vc slots.  Every stage-2 clip
instance (csrc/clip.cu's register pipeline, at every geometry it has) is
bit for bit ops/clip.py:clip_stream_model, which rounds each operation as
the kernel does; against the stage-1 kernel (the same vertices up to the
last bit of an FMA-contracted crossing point, the shoelace summed from
another vertex) areas agree to 1e-6 of the ring's scale.  The stream-reduce
kernel sums in f64 where its plain version sums in f32, so they agree to
1e-5 of sum |x|; a resumed coupler is bit for bit the one that was not
interrupted (no float atomics anywhere in a step).  The stream-only floors
and their plain versions add the same f32 values in the same order, so they
agree bit for bit; the tile product's f32 multiply-add chain of 128 terms
agrees with its plain version (f64, rounded once) and with torch.bmm (TF32
off) within 130 * 2**-24 of sum |T * F|.  The dest-small probe kernels
(csrc/k2probe.cu) follow their plain versions' summation orders, so they
agree bit for bit, also on data whose large terms cancel (any other order
gives other bits); slots(1) and group(1) keep the stage-1 K2's order (a
warp a row), bit for bit each other.  The stage-2 spmm_dest_small is bit
for bit spmm_dest_small_ref, the plain version of its own order, at every
geometry it has an instance for.  So do the dest-ice probe kernels
(csrc/k1probe.cu), and those in K1's order (slots(1), every batch, ablate
row, stage scale, every store) are bit for bit spmm_dest_ice, signed zeros
included, in both of K1's field layouts.  The fold
kernels (csrc/foldprobe.cu) and the shared-memory copies
(csrc/smemprobe.cu) only move values (and double them), so they agree with
their plain versions bit for bit.  A two-sheet coupler on the card
is held to its CPU run as phase 6 of chip_smoke.py holds the toy (1e-5 of
the ice state, 1e-6 of each ledger row), and the gcmce C ABI on the card
is bit for bit the adapter driven directly.  The ModelE mismatched
matrices (regrid/modele.py) through K1 and K2 agree with their plain
versions to one f32 ulp and with the f64 WeightedMatrix.apply within the
raw bound of 5e-7 (tests/test_accuracy_contract.py).  The ordered
segment-sum kernel (csrc/segsum.cu) adds each segment left to right, as
its plain version does, so they agree bit for bit (also on cancelling
terms); regeneration on the card (regrid/device.py) at Antarctica's 5 km
exchange grid is the host factory bit for bit.
"""
import ctypes

import numpy as np
import pytest
import torch

from icebin_tpu_torch.ops import apply as ap
from icebin_tpu_torch.ops.apply import (apply_ice, apply_small, spmm_dest_ice,
                                        spmm_dest_small, spmm_dest_small_ref,
                                        spmm_ref)
from icebin_tpu_torch.ops import clip as cl
from icebin_tpu_torch.ops.clip import (clip_areas_centroids,
                                       clip_areas_centroids_poly,
                                       clip_areas_centroids_poly_ref,
                                       clip_areas_centroids_ref)
from icebin_tpu_torch.ops.csr import csr_pack
from icebin_tpu_torch.ops import k1probe as k1p
from icebin_tpu_torch.ops import k2probe as kp
from icebin_tpu_torch.ops import smemprobe as sm
from icebin_tpu_torch.ops.foldprobe import (FOLDS, ROUTES, fold_tiles,
                                            fold_tiles_ref, shapes)
from icebin_tpu_torch.ops.floor import (spmm_floor_ice, spmm_floor_ice_ref,
                                        spmm_floor_small,
                                        spmm_floor_small_ref)
from icebin_tpu_torch.ops.prods import tile_prods, tile_prods_ref
from icebin_tpu_torch.ops.roof import stream_reduce, stream_reduce_ref
from icebin_tpu_torch.regrid.sparse import WeightedMatrix
from icebin_tpu_torch.tools import probe_k2
from icebin_tpu_torch.tools.common import same

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def synth(nx=256, ny=24, ratio=16, nhc=3, seed=0):
    """EvI-shaped matrix: few long E rows, many short ice columns."""
    rng = np.random.default_rng(seed)
    nI = nx * ny
    ii = np.arange(nI)
    ix, iy = ii % nx, ii // nx
    nxa = -(-nx // ratio)
    a = (iy // ratio) * nxa + ix // ratio
    nA = nxa * (-(-ny // ratio))
    elev = rng.uniform(0, 3400, nI)
    hc = np.linspace(0, 3500, nhc)
    k = np.clip(np.searchsorted(hc, elev) - 1, 0, nhc - 2)
    t = (elev - hc[k]) / np.diff(hc)[0]
    area = rng.uniform(20e6, 30e6, nI)
    rows = np.concatenate([a * nhc + k, a * nhc + k + 1])
    cols = np.concatenate([ii, ii])
    vals = np.concatenate([area * (1 - t), area * t])
    keep = rng.uniform(size=len(rows)) > 0.1
    return WeightedMatrix(rows=rows[keep], cols=cols[keep], vals=vals[keep],
                          shape=(nA * nhc, nI))


@pytest.mark.parametrize("nv", [1, 8, 16, 18, 40])
def test_spmm_kernels_match_plain(cuda, nv):
    M = synth(seed=nv)
    pack = csr_pack(M, nv=16, device=cuda)
    rng = np.random.default_rng(nv)
    for kern, csr in ((spmm_dest_small, pack.small),
                      (spmm_dest_ice, pack.ice)):
        x = rng.uniform(250.0, 300.0, (csr.n_src, nv)).astype(np.float32)
        x[::7, 0] = np.nan                      # masked sources count as 0
        x[::11, -1] = np.inf
        xt = torch.as_tensor(x, device=cuda)
        for scale in (True, False):
            n0 = kern.launches
            got = kern(csr, xt, scale)
            assert kern.launches == n0 + 1
            want = spmm_ref(csr, xt, scale)
            torch.cuda.synchronize()
            ulp = torch.finfo(torch.float32).eps * want.abs()
            assert bool(((got - want).abs() <= ulp).all())
            assert torch.equal(got, kern(csr, xt, scale))   # no atomics


def test_applies_on_cuda_match_cpu(cuda):
    M = synth(seed=3)
    g = csr_pack(M, nv=16, device=cuda)
    c = csr_pack(M, nv=16, device=torch.device("cpu"))
    f = torch.as_tensor(np.random.default_rng(0).uniform(
        0.5, 1.5, (10, M.shape[1])), dtype=torch.float32)
    e_g, e_c = apply_small(g, f.to(cuda)), apply_small(c, f)
    eps = torch.finfo(torch.float32).eps
    assert bool(((e_g.cpu() - e_c).abs() <= eps * e_c.abs()).all())
    i_g, i_c = apply_ice(g, e_c.to(cuda)), apply_ice(c, e_c)
    assert bool(((i_g.cpu() - i_c).abs() <= eps * i_c.abs()).all())


@pytest.mark.parametrize("V", [8, 16])
def test_clip_kernel_matches_plain(cuda, V):
    rng = np.random.default_rng(V)
    B = 4096
    ang = np.sort(rng.uniform(0, 2 * np.pi, (B, V)), axis=1)
    r = rng.uniform(0.2, 1.5, (B, 1))
    polys = np.stack([r * np.cos(ang), r * np.sin(ang)], -1)
    polys[::3, V // 2:] = polys[::3, V // 2 - 1:V // 2]    # duplicate-padded
    h = rng.uniform(0.1, 1.0, (B, 2))
    rects = np.stack([-h[:, 0], -h[:, 1], h[:, 0], h[:, 1]], -1)
    p = torch.as_tensor(polys, dtype=torch.float32, device=cuda)
    q = torch.as_tensor(rects, dtype=torch.float32, device=cuda)
    n0 = clip_areas_centroids.launches
    a, c = clip_areas_centroids(p, q)
    assert clip_areas_centroids.launches == n0 + 1
    a_r, c_r = clip_areas_centroids_ref(p, q)
    torch.cuda.synchronize()
    assert float((a - a_r).abs().max()) < 1e-5
    big = a_r.abs() > 1e-2
    assert float((c - c_r)[big].abs().max()) < 1e-4


def test_clip_kernel_nonconvex(cuda):
    L = np.array([[0, 0], [2, 0], [2, 1], [1, 1], [1, 2], [0, 2]], float)
    boxes = [((0, 0, 2, 2), 3.0), ((0, 0, 2, 0.5), 1.0),
             ((0.5, 0.5, 2, 2), 1.25)]
    polys, rects, want = [], [], []
    for (x0, y0, x1, y1), area in boxes:
        c = np.array([(x0 + x1) / 2, (y0 + y1) / 2])
        ring = L - c
        polys.append(np.concatenate([ring, np.repeat(ring[-1:], 10, 0)]))
        hx, hy = (x1 - x0) / 2, (y1 - y0) / 2
        rects.append([-hx, -hy, hx, hy])
        want.append(area)
    a, _ = clip_areas_centroids(
        torch.as_tensor(np.array(polys), dtype=torch.float32, device=cuda),
        torch.as_tensor(np.array(rects), dtype=torch.float32, device=cuda))
    np.testing.assert_allclose(a.cpu().numpy(), want, atol=1e-6)


def comb_rings(rng, B, V):
    """Combs of V // 4 teeth, rotated and scaled at random: a clip edge
    through them crosses each tooth, so the clipped ring grows past the
    subject's slots (to 15 and 25 vertices at V0 = 8 and 16).  No convex
    clip reaches csrc/clip.cu's ring bound on every pass: after one pass
    the crossing points lie on one line, which the next clip line meets
    once.  The buffers are sized to the bound all the same."""
    h = V // 2
    t = np.linspace(-1.0, 1.0, h)
    top = np.stack([t, np.where(np.arange(h) % 2, 1.2, -0.2)], -1)
    ring = np.concatenate([np.stack([t[::-1], np.full(h, -1.3)], -1), top])
    th = rng.uniform(0, 2 * np.pi, B)
    c, s = np.cos(th)[:, None], np.sin(th)[:, None]
    x, y = ring[None, :, 0], ring[None, :, 1]
    k = rng.uniform(0.6, 1.4, (B, 1))
    return np.stack([k * (c * x - s * y), k * (s * x + c * y)], -1)


@pytest.mark.parametrize("Vc", [4, 8])
@pytest.mark.parametrize("V0", [8, 16])
def test_convex_clip_kernel_matches_plain(cuda, V0, Vc):
    rng = np.random.default_rng(10 * V0 + Vc)
    B = 4096
    ang = np.sort(rng.uniform(0, 2 * np.pi, (B, V0)), axis=1)
    r = rng.uniform(0.2, 1.5, (B, 1))
    polys = np.stack([r * np.cos(ang), r * np.sin(ang)], -1)
    polys[::3, V0 // 2:] = polys[::3, V0 // 2 - 1:V0 // 2]   # padded
    polys[1::2] = comb_rings(rng, B // 2, V0)
    n = rng.integers(3, Vc + 1, B)            # clip rings of 3..Vc vertices
    ang = np.sort(rng.uniform(0, 2 * np.pi, (B, Vc)), axis=1)
    slot = np.minimum(np.arange(Vc)[None, :], n[:, None] - 1)
    ang = np.take_along_axis(ang, slot, axis=1)          # duplicate-padded
    r = rng.uniform(0.5, 1.2, (B, 1))
    clips = np.stack([r * np.cos(ang), r * np.sin(ang)], -1)
    p = torch.as_tensor(polys, dtype=torch.float32, device=cuda)
    q = torch.as_tensor(clips, dtype=torch.float32, device=cuda)
    n0 = clip_areas_centroids_poly.launches
    a, c = clip_areas_centroids_poly(p, q)
    assert clip_areas_centroids_poly.launches == n0 + 1
    a_r, c_r = clip_areas_centroids_poly_ref(p, q)
    torch.cuda.synchronize()
    assert float((a - a_r).abs().max()) < 1e-5
    big = a_r.abs() > 1e-2
    assert float((c - c_r)[big].abs().max()) < 1e-4
    assert torch.equal(a, clip_areas_centroids_poly(p, q)[0])


def clip_cases(V0, Vc, seed=0, B=64):
    """Clip pairs that reach every branch of a clip stage, as the engines
    recentre them: subject rings (B + 12, V0, 2) -- random convex rings of
    3..V0 vertices duplicate-padded, combs (``comb_rings``), an L-shaped
    (non-convex) ring, rings wholly inside and wholly outside the clip, a
    ring around the whole clip, one sharing only an edge with it (a
    degenerate overlap) and a collinear one -- against centred rectangles
    (B + 12, 4) for ``Vc = 0``, else convex CCW clip rings of Vc vertices,
    duplicate-padded to 4 or 8 slots (every third with a zero-length edge
    inside the ring) and recentred on the mean of their slots.  f32 numpy
    arrays.""" 
    rng = np.random.default_rng(seed + 100 * V0 + Vc)
    n = rng.integers(3, V0 + 1, B)
    ang = np.sort(rng.uniform(0, 2 * np.pi, (B, V0)), axis=1)
    ang = np.take_along_axis(ang, np.minimum(np.arange(V0)[None, :],
                                             n[:, None] - 1), axis=1)
    r = rng.uniform(0.2, 1.5, (B, 1))
    polys = np.stack([r * np.cos(ang), r * np.sin(ang)], -1)
    polys[1::2] = comb_rings(rng, B // 2, V0)
    th = 0.1 + 2 * np.pi * np.arange(V0) / V0
    unit = np.stack([np.cos(th), np.sin(th)], -1)     # a regular V0-gon
    L = np.array([[0, 0], [2, 0], [2, 1], [1, 1], [1, 2], [0, 2]], float)
    L = np.concatenate([L, np.repeat(L[-1:], V0 - 6, 0)])
    line = np.stack([np.linspace(-1, 1, V0), np.linspace(-0.5, 0.5, V0)], -1)
    side = np.array([[0.1, -0.1], [0.9, -0.1], [0.9, 0.1], [0.1, 0.1]])
    side = np.concatenate([side, np.repeat(side[-1:], V0 - 4, 0)])
    extra = [L - 1.0, L - [0.5, 1.5], L * 0.3 - 0.3,   # L across, inside
             0.05 * unit, 0.05 * unit + 0.02,         # wholly inside
             0.5 * unit + 5.0, 0.5 * unit - [0.0, 7.0],   # wholly outside
             20.0 * unit, 9.0 * unit[::-1],           # around the clip
                                                      # (the second CW)
             line, 0.0 * line,                        # collinear, a point
             side]                                    # an edge shared
    polys = np.concatenate([polys, np.array(extra)]).astype(np.float32)
    m = len(polys)
    if Vc == 0:
        h = rng.uniform(0.1, 1.0, (m, 2))
        h[-1] = (0.1, 0.1)         # the last ring's left edge is x = 0.1
        return polys, np.stack([-h[:, 0], -h[:, 1], h[:, 0], h[:, 1]],
                               -1).astype(np.float32)
    kc = 4 if Vc <= 4 else 8
    ang = np.sort(rng.uniform(0, 2 * np.pi, (m, Vc)), axis=1)
    rc = rng.uniform(0.5, 1.2, (m, 1))
    ring = np.stack([rc * np.cos(ang), rc * np.sin(ang)], -1)
    slot = np.minimum(np.arange(kc), Vc - 1)[None, :].repeat(m, 0)
    j = rng.integers(0, Vc - 1, m)            # a zero-length edge at j
    inner = (np.arange(m) % 3 == 0) & (Vc < kc)
    slot[inner] = np.minimum(np.arange(kc)[None, :]
                             - (np.arange(kc)[None, :] > j[inner, None]),
                             Vc - 1)
    clips = np.take_along_axis(ring, slot[:, :, None], axis=1)
    clips -= clips.mean(axis=1, keepdims=True)   # as recentre_poly_pairs
    side_clip = np.array([[0.1, -0.1], [0.1, 0.1], [-0.1, 0.1],
                          [-0.1, -0.1]])
    clips[-1] = np.concatenate([side_clip, np.repeat(side_clip[-1:],
                                                     kc - 4, 0)])
    return polys, clips.astype(np.float32)


def stream_shapes():
    """(V0, Vc) of every stage-2 instance; Vc = 0 clips rectangles."""
    return [(v0, vc) for vc in (0,) + cl.KERNEL_VC for v0 in cl.KERNEL_V0]


def clip_inputs(V0, Vc, cuda):
    """``clip_cases`` (12 clip rings of 3..Vc vertices for Vc in 4, 8)
    followed by 4,096 seeded pairs, on the card."""
    vcs = [Vc] if Vc == 0 else [v for v in (3, 4, 6, 8)
                                if (4 if v <= 4 else 8) == Vc]
    parts = [clip_cases(V0, v, seed=1) for v in vcs]
    parts.append(clip_cases(V0, Vc, seed=2, B=4096 - 12))
    P = np.concatenate([p for p, _ in parts])
    Q = np.concatenate([q for _, q in parts])
    return P, Q, (torch.as_tensor(P, device=cuda),
                  torch.as_tensor(Q, device=cuda))


@pytest.mark.parametrize("V0,Vc", stream_shapes())
def test_stage2_clip_bit_for_bit_the_model(cuda, V0, Vc):
    """Every stage-2 instance (threads, min blocks, route) and the wrapper's
    rule, bit for bit clip_stream_model, signed zeros included."""
    from icebin_tpu_torch.tools.sweep_clip import MIN_BLOCKS, SWEPT, THREADS
    P, Q, (p, q) = clip_inputs(V0, Vc, cuda)
    a_m, c_m = (torch.as_tensor(t, device=cuda)
                for t in cl.clip_stream_model(P, Q))
    wrap = clip_areas_centroids if Vc == 0 else clip_areas_centroids_poly
    runs = {"rule": lambda: wrap(p, q)}
    for threads in THREADS:
        for mb in MIN_BLOCKS if (V0, Vc) in SWEPT else (1,):
            for route in cl.ROUTES:
                runs[(threads, mb, route)] = (
                    lambda t=threads, m=mb, r=route:
                    cl.clip_stream_at(p, q, t, m, r))
    for geometry, fn in runs.items():
        a, c = fn()
        torch.cuda.synchronize()
        assert same(a, a_m) and same(c, c_m), geometry


@pytest.mark.parametrize("V0,Vc", stream_shapes())
def test_stage2_clip_against_stage1_and_plain(cuda, V0, Vc):
    """Stage 2 within 1e-6 of the clip's area of stage 1 and within the
    existing limits of the plain version (1e-5 of the ring's scale in area,
    1e-4 in centroid where the overlap is not a sliver); each entry point
    counts its launches."""
    _, _, (p, q) = clip_inputs(V0, Vc, cuda)
    if Vc == 0:
        wrap, compact = clip_areas_centroids, cl.clip_areas_centroids_compact
        ref = clip_areas_centroids_ref
    else:
        wrap = clip_areas_centroids_poly
        compact = cl.clip_areas_centroids_poly_compact
        ref = clip_areas_centroids_poly_ref
    n2, n1 = wrap.launches, compact.launches
    a, c = wrap(p, q)
    a1, c1 = compact(p, q)
    assert (wrap.launches, compact.launches) == (n2 + 1, n1 + 1)
    a_r, c_r = ref(p, q)
    torch.cuda.synchronize()
    if Vc == 0:
        clip_area = (q[:, 2] - q[:, 0]) * (q[:, 3] - q[:, 1])
    else:
        x, y = q[:, :, 0], q[:, :, 1]
        clip_area = 0.5 * (x * y.roll(-1, 1) - x.roll(-1, 1) * y).sum(1)
    assert float(((a - a1).abs() / clip_area).max()) < 1e-6
    assert float((a - a_r).abs().max()) < 1e-5
    big = a_r.abs() > 1e-2
    assert float((c - c_r)[big].abs().max()) < 1e-4
    assert float((c - c1)[big].abs().max()) < 1e-4


def test_wrappers_raise_on_bad_cuda_operands(cuda):
    M = synth(seed=1)
    pack = csr_pack(M, nv=16, device=cuda)
    x = torch.ones((pack.small.n_src, 4), device=cuda)
    with pytest.raises(ValueError):
        spmm_dest_small(pack.small, x.double())
    with pytest.raises(ValueError):
        spmm_dest_small(pack.small, x.cpu())        # matrix on another device
    with pytest.raises(ValueError):
        clip_areas_centroids(torch.zeros((4, 12, 2), device=cuda),
                             torch.zeros((4, 4), device=cuda))
    p = torch.zeros((4, 8, 2), device=cuda)
    for q in (torch.zeros((4, 6, 2), device=cuda),           # Vc = 6
              torch.zeros((4, 8, 2), device=cuda).double(),  # f64
              torch.zeros((3, 8, 2), device=cuda),           # batch
              torch.zeros((4, 8, 2))):                       # on the CPU
        with pytest.raises(ValueError):
            clip_areas_centroids_poly(p, q)


@pytest.mark.parametrize("shape", [(1, 4), (37, 132), (2048, 4096),
                                   (100003, 128)])
def test_stream_reduce_matches_plain(cuda, shape):
    """Odd row counts, a ragged column tile, the probe's (R, 32 x 128) and
    bench_roof's (R, 128) layouts; reruns bit-identical."""
    g = torch.Generator(device=cuda)
    g.manual_seed(shape[0])
    x = torch.rand(shape, generator=g, device=cuda) * 2 - 1
    c = torch.rand(shape[1], generator=g, device=cuda)
    n0 = stream_reduce.launches
    y = stream_reduce(x, c)
    assert stream_reduce.launches == n0 + 1
    want = stream_reduce_ref(x, c)
    torch.cuda.synchronize()
    scale = x.abs().sum(0) + c.abs()
    assert float(((y - want).abs() / scale).max()) < 1e-5
    assert torch.equal(y, stream_reduce(x, c))
    assert torch.equal(stream_reduce(x), stream_reduce(x, torch.zeros_like(c)))
    with pytest.raises(ValueError):
        stream_reduce(x[:, :3].contiguous())              # W % 4 != 0
    with pytest.raises(ValueError):
        stream_reduce(x.t())                              # not contiguous
    with pytest.raises(ValueError):
        stream_reduce(x, c.cpu())                         # c elsewhere


def test_resume_is_bit_identical_on_the_card(cuda, tmp_path):
    """A toy coupler on the card: 3 steps, a checkpoint, 3 more; the
    checkpoint loaded into a fresh coupler runs the same 3 steps to the
    same state and ledger bit for bit."""
    import icebin_tpu_torch as port
    from icebin_tpu_torch.coupler.checkpoint import (load_checkpoint,
                                                     save_checkpoint)
    from icebin_tpu_torch.grid import GridSpecLonLat, GridSpecXY, PlateCarree
    s = 25e3
    specA = GridSpecLonLat(lonb=np.linspace(0.0, 40.0, 7),
                           latb=np.linspace(30.0, 80.0, 7))
    specI = GridSpecXY(xb=np.linspace(0.0, 40.0 * s, 41),
                       yb=np.linspace(30.0 * s, 80.0 * s, 41),
                       projection=PlateCarree(scale=s))

    def make():
        gr = port.GCMRegridder(specA, [0.0, 500.0, 1000.0, 2000.0],
                               device=cuda)
        gr.add_sheet("toy", specI, subdiv=1)
        return port.GCMCoupler(gr, port.CouplerConfig(regen_every=2),
                               device=cuda)

    def fn(t, sheet):
        rng = np.random.default_rng(int(t) % 100003)
        f = np.zeros((8, nE), np.float32)
        f[0] = 1e-5 * rng.uniform(0.5, 1.0, nE)
        f[1] = 5.0
        f[4] = -10.0
        return torch.as_tensor(f, device=cuda)

    a = make()
    nE = a.gr.nE
    a.run_transient(fn, 3)
    ck = str(tmp_path / "ck.npz")
    save_checkpoint(ck, a)
    a.run_transient(fn, 3)
    b = make()
    load_checkpoint(ck, b)
    assert b.sheets["toy"].state.H.device == a.sheets["toy"].state.H.device
    b.run_transient(fn, 3)
    for k in ("H", "enth", "t"):
        assert torch.equal(getattr(a.sheets["toy"].state, k),
                           getattr(b.sheets["toy"].state, k)), k
    assert a.ledger.to_rows() == b.ledger.to_rows()


@pytest.mark.parametrize("nv", [1, 16, 20, 64])
def test_floor_kernels_match_plain(cuda, nv):
    """Both floors bit for bit their plain versions (the same f32 adds in
    the same order), non-finite sources propagating; reruns identical."""
    M = synth(seed=20 + nv)
    pack = csr_pack(M, nv=16, device=cuda)
    rng = np.random.default_rng(nv)
    for kern, ref, csr in ((spmm_floor_small, spmm_floor_small_ref,
                            pack.small),
                           (spmm_floor_ice, spmm_floor_ice_ref, pack.ice)):
        x = rng.uniform(-1.0, 2.0, (csr.n_src, nv)).astype(np.float32)
        x[::13, 0] = np.nan
        xt = torch.as_tensor(x, device=cuda)
        n0 = kern.launches
        got = kern(csr, xt)
        assert kern.launches == n0 + 1
        want = ref(csr, xt)
        torch.cuda.synchronize()
        assert torch.equal(torch.nan_to_num(got, nan=7.0),
                           torch.nan_to_num(want, nan=7.0))
        assert bool(torch.isnan(got[:, 0]).any())
        assert torch.equal(torch.nan_to_num(got, nan=7.0),
                           torch.nan_to_num(kern(csr, xt), nan=7.0))


def test_tile_prods_matches_plain_and_bmm(cuda):
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    B = 777
    T = torch.rand((B, 32, 128), generator=g, device=cuda) * 2 - 1
    F = torch.rand((B, 8, 128), generator=g, device=cuda) * 2 - 1
    n0 = tile_prods.launches
    got = tile_prods(T, F)
    assert tile_prods.launches == n0 + 1
    mag = torch.matmul(T.abs().double(), F.abs().double().transpose(1, 2))
    tol = 130 * 2.0 ** -24 * mag
    assert bool(((got.double() - tile_prods_ref(T, F).double()).abs()
                 <= tol).all())
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = torch.bmm(T, F.transpose(1, 2))
    assert bool(((got.double() - lib.double()).abs() <= 2 * tol).all())
    assert torch.equal(got, tile_prods(T, F))
    with pytest.raises(ValueError):                 # not 16-byte aligned
        tile_prods(T.reshape(-1)[1:1 + T.numel() - 4096].reshape(B - 1, 32,
                                                                 128), F[1:])


def two_sheet_specs():
    """A 6 x 6 lat-lon atmosphere over two plate carree sheets, west and
    east, that touch disjoint A cells."""
    from icebin_tpu_torch.grid import GridSpecLonLat, GridSpecXY, PlateCarree
    s = 25e3
    specA = GridSpecLonLat(lonb=np.linspace(0.0, 40.0, 7),
                           latb=np.linspace(30.0, 80.0, 7))
    sheets = {name: GridSpecXY(xb=np.linspace(x0 * s, x1 * s, 25),
                               yb=np.linspace(30.0 * s, 80.0 * s, 41),
                               projection=PlateCarree(scale=s))
              for name, x0, x1 in (("west", 0.0, 20.0),
                                   ("east", 20.0, 40.0))}
    return specA, sheets


def toy_forcing(nE, seed):
    rng = np.random.default_rng(seed)
    f = np.zeros((8, nE), np.float32)
    f[0] = 1e-5 * rng.uniform(0.5, 1.0, nE)
    f[1] = 5.0
    f[4] = -10.0
    return f


def test_two_sheet_coupler_on_the_card_matches_cpu(cuda):
    import icebin_tpu_torch as port
    specA, sheets = two_sheet_specs()
    runs = []
    for dev in (cuda, torch.device("cpu")):
        gr = port.GCMRegridder(specA, [0.0, 500.0, 1000.0, 2000.0],
                               device=dev)
        for name, specI in sheets.items():
            gr.add_sheet(name, specI, subdiv=1)
        cp = port.GCMCoupler(gr, port.CouplerConfig(regen_every=2),
                             device=dev)
        for k in range(3):
            f = toy_forcing(gr.nE, k)
            cp.couple({name: torch.as_tensor(f, device=dev)
                       for name in sheets})
        runs.append(cp)
    g, c = runs
    for name in sheets:
        hg, hc = g.sheets[name].state.H.cpu(), c.sheets[name].state.H
        assert float((hg - hc).abs().max() / hc.abs().max()) < 1e-5
    for rg, rc in zip(g.ledger.to_rows(), c.ledger.to_rows()):
        for name in sheets:
            for key in ("mass_in_E", "mass_delivered_I", "ice_mass",
                        "energy_in_E", "energy_delivered_I"):
                a, b = rg[f"{name}.{key}"], rc[f"{name}.{key}"]
                assert abs(a - b) <= 1e-6 * abs(b), (name, key)
            m = rg[f"{name}.mass_in_E"]
            assert abs(m - rg[f"{name}.mass_delivered_I"]) < 1e-10 * abs(m)


def test_gcmce_c_abi_on_the_card(cuda, tmp_path):
    """gcmce_* through ctypes, as a Fortran GCM calls it: two ranks'
    forcing per step, three couple_native calls on the card (a matrix
    regeneration after the second, so TOPO depends on the forcing).  The
    TOPO buffers of every step, the ledger rows and the sheets' ice state
    are bit for bit an adapter on the card driven directly with the same
    forcing."""
    import icebin_tpu_torch as port
    from icebin_tpu_torch.io.ncio import write_grid
    from icebin_tpu_torch.models import gcmce_shim
    from icebin_tpu_torch.models.modele_adapter import (ModelEAdapter,
                                                        to_modele_E)
    from icebin_tpu_torch.ops._build_gcmce import gcmce_library
    from icebin_tpu_torch.utils.config import RunConfig, SheetConfig
    specA, sheets = two_sheet_specs()
    hc = [0.0, 500.0, 1000.0, 2000.0]
    paths = {"A": str(tmp_path / "a.nc")}
    write_grid(paths["A"], specA)
    for name, specI in sheets.items():
        paths[name] = str(tmp_path / f"{name}.nc")
        write_grid(paths[name], specI)
    cfg = str(tmp_path / "run.json")
    RunConfig(gridA_file=paths["A"], hcdefs=hc, regen_every=2,
              sheets=[SheetConfig(name=n, grid_file=paths[n], subdiv=1)
                      for n in sheets]).to_json(cfg)
    lib = ctypes.CDLL(str(gcmce_library()))
    lib.gcmce_new.restype = ctypes.c_int
    h = lib.gcmce_new(cfg.encode())
    assert h > 0
    im, jm, nhc = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    assert lib.gcmce_dims(h, ctypes.byref(im), ctypes.byref(jm),
                          ctypes.byref(nhc)) == 0
    assert (im.value, jm.value, nhc.value) == (6, 6, 4)
    gr = port.GCMRegridder(specA, hc, device=cuda)
    for name, specI in sheets.items():
        gr.add_sheet(name, specI, subdiv=1)
    direct = ModelEAdapter(gr, port.CouplerConfig(regen_every=2),
                           device=cuda)
    nE = gr.nE
    p64, pd = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double)
    for step in range(3):
        fm = to_modele_E(toy_forcing(nE, step).astype(np.float64), gr.nA,
                         gr.nhc)
        for lo, hi in ((0, nE // 2), (nE // 2, nE)):
            idx = np.arange(lo, hi, dtype=np.int64)
            vals = np.ascontiguousarray(fm[:, lo:hi])
            lib.gcmce_add_gcm_outpute(h, idx.ctypes.data_as(p64),
                                      vals.ctypes.data_as(pd),
                                      ctypes.c_int64(hi - lo), 8)
            direct.add_rank_output(idx, vals)
        fhc, elevE = np.zeros(nE), np.zeros(nE)
        under = np.zeros(nE, np.int32)
        assert lib.gcmce_couple_native(
            h, ctypes.c_double(step * 86400.0 * 30), fhc.ctypes.data_as(pd),
            elevE.ctypes.data_as(pd),
            under.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_int64(nE)) == 0
        direct.couple_native(step * 86400.0 * 30)
        for got, want in zip((fhc, elevE, under), direct.topo()):
            np.testing.assert_array_equal(got, want.reshape(-1))
        assert set(np.unique(under)) == {0, 1, 2}   # both sheets present
    ad = gcmce_shim._handles[h]
    assert ad.coupler.ledger.to_rows() == direct.coupler.ledger.to_rows()
    assert len(ad.coupler.ledger.to_rows()) == 3
    for name in sheets:
        for key in ("H", "enth"):
            assert torch.equal(getattr(ad.coupler.sheets[name].state, key),
                               getattr(direct.coupler.sheets[name].state,
                                       key)), (name, key)
    lib.gcmce_delete(h)


K2PROBES = ((kp.spmm_small_slots, kp.spmm_small_slots_ref, kp.SLOTS),
            (kp.spmm_small_group, kp.spmm_small_group_ref, kp.GROUPS),
            (kp.spmm_small_batch, kp.spmm_small_batch_ref, kp.BATCH),
            (kp.spmm_small_ablate, kp.spmm_small_ablate_ref, kp.MODES))


@pytest.mark.parametrize("nv", [1, 16, 20, 64])
def test_k2probe_kernels_match_plain(cuda, nv):
    """Every dest-small probe kernel at every parameter bit for bit its
    plain version, on the synthetic EvI (a row of 600 nonzeros, NaN and inf
    sources) and on probe_k2.order_case's cancelling data; reruns
    identical; slots(1) and group(1) bit for bit each other, the stage-1
    K2's order."""
    M = probe_k2.synth(seed=nv)
    evi = (csr_pack(M, nv=16, device=cuda).small,
           torch.as_tensor(probe_k2.fields(M.shape[1], nv, seed=nv),
                           device=cuda))
    csr, x = probe_k2.order_case(nv, nv, device=cuda)
    for c, xt in (evi, (csr, torch.as_tensor(x, device=cuda))):
        stage1 = kp.spmm_small_slots(c, xt, 1)
        for kern, ref, params in K2PROBES:
            for p in params:
                n0 = kern.launches
                got = kern(c, xt, p)
                assert kern.launches == n0 + 1
                want = ref(c, xt, p)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (kern.__name__, p)
                assert torch.equal(got, kern(c, xt, p)), (kern.__name__, p)
                if p == 1:
                    assert torch.equal(got, stage1), (kern.__name__, p)


K1PROBES = ((k1p.spmm_ice_slots, k1p.spmm_ice_slots_ref, k1p.SLOTS),
            (k1p.spmm_ice_batch, k1p.spmm_ice_batch_ref, k1p.BATCH),
            (k1p.spmm_ice_ablate, k1p.spmm_ice_ablate_ref, k1p.MODES),
            (k1p.spmm_ice_stage, k1p.spmm_ice_stage_ref, k1p.LEVELS),
            (k1p.spmm_ice_store, k1p.spmm_ice_store_ref, k1p.STORES))
K1_ORDER = {1, *k1p.BATCH, "row", *k1p.STORES}


@pytest.mark.parametrize("nv", [1, 16, 20, 64])
def test_k1probe_kernels_match_plain(cuda, nv):
    """Every dest-ice probe kernel at every parameter bit for bit its plain
    version (NaN equal to NaN: the gather stage propagates NaN sources), on
    the IvE side of probe_k2.synth (NaN and inf sources) and on
    probe_k2.order_case's cancelling data (rows of 300 and 700 nonzeros: the
    batch kernels' chunks); reruns identical; the variants in K1's order bit
    for bit spmm_dest_ice."""
    M = probe_k2.synth(seed=nv)
    ive = (csr_pack(M, nv=16, device=cuda).ice,
           torch.as_tensor(probe_k2.fields(M.shape[0], nv, seed=nv),
                           device=cuda))
    csr, x = probe_k2.order_case(nv, nv, device=cuda)
    for c, xt in (ive, (csr, torch.as_tensor(x, device=cuda))):
        k1 = spmm_dest_ice(c, xt)
        xf = xt.t().contiguous()
        for kern, ref, params in K1PROBES:
            for p in params:
                xin = xf if p == "fields" else xt
                n0 = kern.launches
                got = kern(c, xin, p)
                assert kern.launches == n0 + 1
                want = ref(c, xin, p)
                torch.cuda.synchronize()
                assert same(got, want), (kern.__name__, p)
                assert same(got, kern(c, xin, p)), (kern.__name__, p)
                if p in K1_ORDER:
                    got = got.t() if p == "fields" else got
                    assert same(got, k1), (kern.__name__, p)


def test_k1probe_store_buffers_on_the_card(cuda):
    """store writes into the caller's buffer and returns it; rmw reads it
    first (bit for bit its plain version from a non-zero buffer) and keeps
    K1's -0.0 on a zeroed one; a refused operand raises before any
    launch."""
    from icebin_tpu_torch.ops.csr import csr_from_coo
    csr = csr_from_coo([0, 0, 1], [0, 1, 1], [1e-30, 1e-30, 1.0], 2, 2,
                       [1.0, 1.0], device=cuda)
    x = torch.tensor([[-1e-30], [-2e-30]], device=cuda)
    k1 = spmm_dest_ice(csr, x)
    assert bool(torch.signbit(k1[0, 0]))
    out = torch.zeros((2, 1), device=cuda)
    assert k1p.spmm_ice_store(csr, x, "rmw", out=out) is out
    assert same(out, k1)
    M = probe_k2.synth(seed=5)
    c = csr_pack(M, nv=16, device=cuda).ice
    xt = torch.as_tensor(probe_k2.fields(M.shape[0], 16, seed=5),
                         device=cuda)
    held = torch.full((c.n_dst, 16), 2.0, device=cuda)
    want = k1p.spmm_ice_store_ref(c, xt, "rmw", out=held.clone())
    assert same(k1p.spmm_ice_store(c, xt, "rmw", out=held), want)
    # into is K1's own kernel, counted as the store's launch, not K1's
    n0, n1 = k1p.spmm_ice_store.launches, spmm_dest_ice.launches
    assert k1p.spmm_ice_store(c, xt, "into", out=held) is held
    assert k1p.spmm_ice_store.launches == n0 + 1
    assert spmm_dest_ice.launches == n1
    assert same(held, spmm_dest_ice(c, xt))
    n0 = k1p.spmm_ice_store.launches
    for bad in (torch.zeros((c.n_dst, 15), device=cuda),
                torch.zeros((c.n_dst, 16)),                 # on the CPU
                torch.zeros((16, c.n_dst), device=cuda).t()):
        with pytest.raises(ValueError):
            k1p.spmm_ice_store(c, xt, "into", out=bad)
    with pytest.raises(ValueError):
        k1p.spmm_ice_batch(c, xt, 64)                      # no instance
    assert k1p.spmm_ice_store.launches == n0


def stage2_cases(cuda, nv):
    """(csr, (n_src, nv) field) pairs for the dest-small kernel: the
    synthetic EvI without its rows 0-4 (empty rows, a row of 600 nonzeros,
    NaN and inf sources) and probe_k2.order_case's cancelling data."""
    M = probe_k2.synth(seed=nv)
    keep = M.rows >= 5
    M = WeightedMatrix(rows=M.rows[keep], cols=M.cols[keep],
                       vals=M.vals[keep], shape=M.shape)
    evi = (csr_pack(M, nv=16, device=cuda).small,
           torch.as_tensor(probe_k2.fields(M.shape[1], nv, seed=nv),
                           device=cuda))
    csr, x = probe_k2.order_case(nv, nv, device=cuda)
    return evi, (csr, torch.as_tensor(x, device=cuda))


@pytest.mark.parametrize("nv", [1, 8, 16, 18, 40, 64, 136])
def test_stage2_k2_bit_for_bit_its_plain_version(cuda, nv):
    """spmm_dest_small bit for bit spmm_dest_small_ref (scale on and off),
    not the stage-1 order's bits on cancelling data, one launch a call,
    reruns identical, the empty rows +0.0."""
    for c, xt in stage2_cases(cuda, nv):
        for scale in (True, False):
            n0 = spmm_dest_small.launches
            got = spmm_dest_small(c, xt, scale)
            assert spmm_dest_small.launches == n0 + 1
            want = spmm_dest_small_ref(c, xt, scale)
            torch.cuda.synchronize()
            assert same(got, want), scale
            assert same(got, spmm_dest_small(c, xt, scale))
        empty = c.rowptr[1:] == c.rowptr[:-1]
        assert not got[empty].any() and not torch.signbit(got[empty]).any()
    assert not same(spmm_dest_small(c, xt), kp.spmm_small_slots(c, xt, 1))


@pytest.mark.parametrize("nv", [1, 16, 18, 64])
def test_stage2_k2_f64_sums_bit_for_bit_its_plain_version(cuda, nv):
    """spmm_dest_small with f64 outputs (a mesh rank's partials) bit for
    bit spmm_dest_small_ref's f64 sums, scale on and off, one launch a
    call; scaled and rounded to f32 they are the f32 kernel's result."""
    for c, xt in stage2_cases(cuda, nv):
        for scale in (True, False):
            n0 = spmm_dest_small.launches
            got = spmm_dest_small(c, xt, scale, dtype=torch.float64)
            assert spmm_dest_small.launches == n0 + 1
            assert got.dtype == torch.float64
            want = spmm_dest_small_ref(c, xt, scale, dtype=torch.float64)
            torch.cuda.synchronize()
            assert same(got, want), scale
        f32 = spmm_dest_small(c, xt, True)
        assert same(got.mul(c.winv.double()[:, None]).float(), f32)


@pytest.mark.parametrize("nv", [16, 20, 64])
def test_stage2_k2_every_geometry(cuda, nv):
    """The dest-small kernel at every warps-per-row and unroll it has an
    instance for, bit for bit the plain version at that many warps; a
    geometry it has no instance for is refused before any launch."""
    from icebin_tpu_torch.tools.sweep_spmm import UNROLL, WARPS
    for c, xt in stage2_cases(cuda, nv):
        for w in WARPS:
            want = spmm_dest_small_ref(c, xt, True, w)
            for u in UNROLL:
                assert same(ap._small(c, xt, True, w, u), want), (w, u)
    for w, u in ((0, 4), (33, 4), (8, 3)):
        with pytest.raises(RuntimeError):
            ap._small(c, xt, True, w, u)


@pytest.mark.parametrize("nv", [1, 16, 20, 64])
def test_k1_bit_for_bit_the_stage1_k1_in_both_layouts(cuda, nv):
    """spmm_dest_ice on (n_src, nv) and on (nv, n_src), at every chunk and
    register cap it has an instance for, bit for bit the stage-1 K1
    (k1probe's slots(1), a thread an output, and ablate row), unscaled bit
    for bit the weights stage; one launch a call; reruns identical; -0.0
    kept."""
    M = probe_k2.synth(seed=nv)
    ive = (csr_pack(M, nv=16, device=cuda).ice,
           torch.as_tensor(probe_k2.fields(M.shape[0], nv, seed=nv),
                           device=cuda))
    csr, x = probe_k2.order_case(nv, nv, device=cuda)
    for c, xt in (ive, (csr, torch.as_tensor(x, device=cuda))):
        xf = xt.t().contiguous()
        stage1 = k1p.spmm_ice_slots(c, xt, 1)
        assert same(stage1, k1p.spmm_ice_ablate(c, xt, "row"))
        unscaled = k1p.spmm_ice_stage(c, xt, "weights")
        n0 = spmm_dest_ice.launches
        rows, fields = spmm_dest_ice(c, xt), spmm_dest_ice(c, xf, fields=True)
        assert spmm_dest_ice.launches == n0 + 2
        torch.cuda.synchronize()
        assert same(rows, stage1) and same(fields.t(), stage1)
        assert fields.is_contiguous() and fields.shape == (nv, c.n_dst)
        assert same(rows, spmm_dest_ice(c, xt))
        assert same(spmm_dest_ice(c, xf, False, fields=True).t(), unscaled)
        for ch in (4, 8, 16, 32, 64):
            for mb in (1, 8):
                assert same(ap._ice(c, xt, True, False, ch, mb), stage1)
                assert same(ap._ice(c, xf, True, True, ch, mb).t(), stage1)
    from icebin_tpu_torch.ops.csr import csr_from_coo
    c = csr_from_coo([0, 0, 1], [0, 1, 1], [1e-30, 1e-30, 1.0], 3, 2,
                     [1.0, 1.0, 0.0], device=cuda)
    x = torch.tensor([[-1e-30], [-2e-30]], device=cuda)
    for got in (spmm_dest_ice(c, x), spmm_dest_ice(c, x.t().contiguous(),
                                                   fields=True).t()):
        assert bool(torch.signbit(got[0, 0])) and got[0, 0] == 0
        assert same(got, k1p.spmm_ice_slots(c, x, 1))


def test_apply_ice_runs_the_fields_layout(cuda):
    """apply_ice hands (nv, n) to K1: one launch per nv-wide group, the
    result contiguous and bit for bit the stage-1 apply_ice's transposes
    path; a misaligned field (a view one float in) gives the same bits
    through both kernels."""
    M = probe_k2.synth(seed=6)
    pack = csr_pack(M, nv=8, device=cuda)
    f = torch.as_tensor(probe_k2.fields(M.shape[0], 13, seed=6).T.copy(),
                        device=cuda)
    n0 = spmm_dest_ice.launches
    got = apply_ice(pack, f)
    assert spmm_dest_ice.launches == n0 + 2 and got.is_contiguous()
    old = torch.cat([spmm_dest_ice(pack.ice, f[k:k + 8].t().contiguous()).t()
                     for k in range(0, 13, 8)])
    assert same(got, old)
    for kern, csr in ((spmm_dest_small, pack.small), (spmm_dest_ice,
                                                      pack.ice)):
        x = torch.as_tensor(probe_k2.fields(csr.n_src, 16, seed=1),
                            device=cuda)
        buf = torch.empty(x.numel() + 1, device=cuda)
        moved = buf[1:].view(x.shape).copy_(x)
        assert moved.data_ptr() % 16 != 0
        assert same(kern(csr, moved), kern(csr, x)), kern.__name__
    with pytest.raises(ValueError):
        spmm_dest_ice(pack.ice, f[:8].t().contiguous(), fields=True)
    for ch, u in ((0, 4), (12, 4), (48, 4), (16, 2)):
        with pytest.raises(RuntimeError):
            ap._ice(pack.ice, f[:8].contiguous(), True, True, ch, u)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("fold", FOLDS)
def test_fold_tiles_match_plain(cuda, fold, route, dtype):
    for B in (1, 64, 1000):
        x = np.random.default_rng(B).uniform(-1, 1, (B, *shapes(fold)[0]))
        x = torch.as_tensor(x, dtype=dtype, device=cuda)
        n0 = fold_tiles.launches
        got = fold_tiles(x, fold, route)
        torch.cuda.synchronize()
        assert fold_tiles.launches == n0 + 1
        assert got.dtype == dtype and tuple(got.shape[1:]) == shapes(fold)[1]
        assert same(got, fold_tiles_ref(x, fold))


def test_smem_copy_kernels_match_plain(cuda):
    for n, scope, cluster in ((200, "block", 1), (200, "cluster", 2),
                              (1000, "cluster", 8), (3000, "cluster", 16)):
        x = sm.rows_data(n, cuda)
        n0 = sm.smem_copy.launches
        got = sm.smem_copy(x, scope, cluster)
        torch.cuda.synchronize()
        assert sm.smem_copy.launches == n0 + 1
        assert same(got, x * 2.0)


def test_smem_copy_oversize_is_refused_not_raised(cuda):
    """A size over the limit raises Refused (a launch-configuration
    refusal), leaves the card usable, and the bisect reports it; one block's
    limit is the card's opt-in shared memory."""
    for n, scope, cluster in ((300, "block", 1), (16 * 300, "cluster", 16)):
        with pytest.raises(sm.Refused) as e:
            sm.smem_copy(sm.rows_data(n, cuda), scope, cluster)
        assert e.value.status in sm.REFUSALS
    x = sm.rows_data(100, cuda)
    got = sm.smem_copy(x)
    torch.cuda.synchronize()
    assert same(got, x * 2.0)
    found = sm.largest_rows("block", 1, cuda)
    assert found["refusal"] in sm.REFUSALS
    optin = getattr(torch.cuda.get_device_properties(cuda),
                    "shared_memory_per_block_optin", None)
    if optin:
        assert found["rows"] == optin // 1024


# -- the mesh (icebin_tpu_torch.parallel) on the card -------------------------

def mesh_toy_rank(mesh, steps):
    """``steps`` steps of a toy coupler decomposed over ``mesh`` (a rank of
    ``launch``): the gathered H, the last fE_out, the ledger rows and K1/K2
    launches of this rank; then K2 on a pack whose entries all lie in rank
    0's cells (rank 1 and up hold a matrix with no live row)."""
    import icebin_tpu_torch as port
    from icebin_tpu_torch.parallel.sharded_apply import (
        make_sharded_apply_small, sharded_csr_from_weighted)
    from icebin_tpu_torch.regrid.sparse import WeightedMatrix
    gr = mesh_toy_gr(mesh.device)
    cp = port.GCMCoupler(gr, port.CouplerConfig(regen_every=2), mesh=mesh)
    spmm_dest_ice.launches = spmm_dest_small.launches = 0
    out = None
    for k in range(steps):
        out = cp.couple({"toy": mesh_toy_forcing(gr.nE, k, mesh.device)})
    torch.cuda.synchronize()
    launches = (spmm_dest_ice.launches, spmm_dest_small.launches)
    M = WeightedMatrix(rows=np.arange(8) % 3, cols=np.arange(8),
                       vals=np.ones(8), shape=(3, 64))
    sc = sharded_csr_from_weighted(mesh, M, nv=4)
    x = torch.ones((4, sc.cells_per_shard), device=mesh.device)
    n0 = spmm_dest_small.launches
    e = make_sharded_apply_small(mesh, sc)(x)
    torch.cuda.synchronize()
    return {"H": cp.sheets["toy"].gathered_state().H.cpu().numpy(),
            "fE_out": out["toy"]["fE_out"].cpu().numpy(),
            "rows": cp.ledger.to_rows(), "launches": launches,
            "n_live": sc.pack.small.n_live,
            "empty_launches": spmm_dest_small.launches - n0,
            "e": e.cpu().numpy()}


def mesh_toy_gr(device):
    import icebin_tpu_torch as port
    from icebin_tpu_torch.grid import GridSpecLonLat, GridSpecXY, PlateCarree
    s = 25e3
    specA = GridSpecLonLat(lonb=np.linspace(0.0, 40.0, 7),
                           latb=np.linspace(30.0, 80.0, 7))
    specI = GridSpecXY(xb=np.linspace(0.0, 40.0 * s, 41),
                       yb=np.linspace(30.0 * s, 80.0 * s, 41),
                       projection=PlateCarree(scale=s))
    gr = port.GCMRegridder(specA, [0.0, 1000.0, 3000.0], device=device)
    gr.add_sheet("toy", specI, subdiv=1)
    return gr


def mesh_toy_forcing(nE, k, device):
    f = np.zeros((8, nE), np.float32)
    f[0] = 1e-5 * np.random.default_rng(k).uniform(0.5, 1.0, nE)
    f[4] = -10.0
    return torch.as_tensor(f, device=device)


@pytest.mark.parametrize("n,backend", [(1, "nccl"), (2, "gloo")])
def test_mesh_coupler_on_the_card(cuda, n, backend):
    """The toy coupler decomposed over 1 rank (NCCL) and over 2 gloo ranks
    sharing cuda:0: K1 and K2 launched on every rank, the ledger the same
    on every rank and closing < 1e-10, H and fE_out within the JAX
    package's mesh tolerances (tests/test_mesh_coupler.py:111-116) of the
    single-device coupler on the card, and at one rank H, fE_out and the
    ledger bit for bit the single-device coupler's; K2 on a rank with no
    live EvI row gives zeros without a launch, and the summed result is the
    matrix's."""
    import icebin_tpu_torch as port
    from icebin_tpu_torch.ops import _build
    from icebin_tpu_torch.parallel.distributed import launch
    _build.library()
    res = launch(mesh_toy_rank, n, backend=backend, device="cuda",
                 args=(3,), timeout=600.0)
    gr = mesh_toy_gr(cuda)
    cp = port.GCMCoupler(gr, port.CouplerConfig(regen_every=2), device=cuda)
    for k in range(3):
        out = cp.couple({"toy": mesh_toy_forcing(gr.nE, k, cuda)})["toy"]
    H1 = cp.sheets["toy"].state.H.cpu().numpy()
    e1 = out["fE_out"].cpu().numpy()
    for r in res:
        assert all(k > 0 for k in r["launches"]), r["launches"]
        assert r["rows"] == res[0]["rows"]
        for row in r["rows"]:
            assert (abs(row["toy.mass_in_E"] - row["toy.mass_delivered_I"])
                    / abs(row["toy.mass_in_E"]) < 1e-10)
        np.testing.assert_allclose(r["H"], H1, rtol=2e-5, atol=2e-4)
        ok = np.isfinite(e1)
        np.testing.assert_array_equal(np.isfinite(r["fE_out"]), ok)
        np.testing.assert_allclose(r["fE_out"][ok], e1[ok], rtol=5e-4,
                                   atol=5e-3)
        np.testing.assert_array_equal(r["e"], res[0]["e"])
        np.testing.assert_allclose(r["e"], 1.0, rtol=1e-6)
    if n == 1:
        np.testing.assert_array_equal(res[0]["H"], H1)
        np.testing.assert_array_equal(res[0]["fE_out"], e1)
        assert res[0]["rows"] == cp.ledger.to_rows()
    assert res[0]["n_live"] == 3 and res[0]["empty_launches"] == 1
    for r in res[1:]:
        assert r["n_live"] == 0 and r["empty_launches"] == 0


def test_nccl_more_ranks_than_cards_raises(cuda):
    """NCCL takes one card a rank: more ranks than cards raise before any
    rank starts."""
    from icebin_tpu_torch.parallel.distributed import launch
    with pytest.raises(ValueError, match="nccl"):
        launch(mesh_toy_rank, torch.cuda.device_count() + 1,
               backend="nccl", device="cuda", args=(1,))


def test_mismatched_matrices_through_k1_k2_on_the_card(cuda):
    """GCMRegridderModelE's EvI and AvI through K2 and IvE and IvA through
    K1 (tests/test_topo_modele.py:89's ocean pair, the exchange grid built
    on the host): one launch a call, one f32 ulp from the plain version,
    raw error < 5e-7 against the f64 WeightedMatrix.apply."""
    from icebin_tpu_torch import GCMRegridder
    from icebin_tpu_torch.grid import (GridSpecLonLat, GridSpecXY,
                                       PlateCarree, make_exchange_grid_host)
    from icebin_tpu_torch.regrid.matrices import RegridParams
    from icebin_tpu_torch.regrid.modele import GCMRegridderModelE
    specA = GridSpecLonLat(lonb=np.linspace(0.0, 40.0, 9),
                           latb=np.linspace(30.0, 70.0, 9))
    specO = GridSpecLonLat(lonb=np.linspace(0.0, 40.0, 17),
                           latb=np.linspace(30.0, 70.0, 17))
    s = 25e3
    specI = GridSpecXY(xb=np.linspace(5 * s, 35 * s, 41),
                       yb=np.linspace(35 * s, 65 * s, 41),
                       projection=PlateCarree(scale=s))
    grO = GCMRegridder(specO, [0.0, 1000.0, 3000.0], device=cuda)
    grO.add_sheet("s", specI, subdiv=1,
                  exchange=make_exchange_grid_host(specO, specI, subdiv=1))
    rng = np.random.default_rng(0)
    op = np.clip(rng.uniform(-0.3, 0.6, specO.ncells), 0, 1)
    c = specI.cell_centers()
    r2 = (((c[:, 0] - c[:, 0].mean()) / (15 * s)) ** 2
          + ((c[:, 1] - c[:, 1].mean()) / (15 * s)) ** 2)
    elev = np.where(r2 < 0.5, 3000.0 * (1.0 - r2), np.nan)
    rm = GCMRegridderModelE(grO, specA, op, np.round(op)).regrid_matrices(
        "s", elev)
    for name in ("EvI", "AvI", "IvE", "IvA"):
        M = rm.matrix(name, RegridParams())
        ice = name.startswith("I")
        kern = spmm_dest_ice if ice else spmm_dest_small
        pack = csr_pack(M, small_axis="cols" if ice else "rows", nv=16,
                        device=cuda)
        csr = pack.ice if ice else pack.small
        x = rng.uniform(250.0, 300.0, (M.shape[1], 16)).astype(np.float32)
        xt = torch.as_tensor(x, device=cuda)
        n0 = kern.launches
        got = kern(csr, xt)
        assert kern.launches == n0 + 1
        want = spmm_ref(csr, xt)
        torch.cuda.synchronize()
        ulp = torch.finfo(torch.float32).eps * want.abs()
        assert bool(((got - want).abs() <= ulp).all()), name
        oracle = M.apply(x.astype(np.float64).T).T
        live = M.wM > 0
        g = got.cpu().numpy().astype(np.float64)
        raw = np.abs(g[live] - oracle[live]).max() / np.abs(
            oracle[live]).max()
        assert raw < 5e-7, (name, raw)


# -- the compiled coupling step (coupler/step_graph.py) ----------------------

def graph_toy(cuda, dt=86400.0 * 30, dt_max=None, **kw):
    """The one-sheet toy coupler on the card (25 km cells, 4 ECs), a
    regeneration every 2 steps; ``dt_max`` lifts the SIA's substep cap so
    the CFL binds under a long ``dt``."""
    import dataclasses

    import icebin_tpu_torch as port
    from icebin_tpu_torch.grid import GridSpecLonLat, GridSpecXY, PlateCarree
    s = 25e3
    specA = GridSpecLonLat(lonb=np.linspace(0.0, 40.0, 7),
                           latb=np.linspace(30.0, 80.0, 7))
    specI = GridSpecXY(xb=np.linspace(0.0, 40.0 * s, 41),
                       yb=np.linspace(30.0 * s, 80.0 * s, 41),
                       projection=PlateCarree(scale=s))
    gr = port.GCMRegridder(specA, [0.0, 500.0, 1000.0, 2000.0], device=cuda)
    gr.add_sheet("toy", specI, subdiv=1)
    cp = port.GCMCoupler(gr, port.CouplerConfig(dt=dt, regen_every=2, **kw),
                         device=cuda)
    sc = cp.sheets["toy"]
    if dt_max is not None:
        sc.ice_cfg = dataclasses.replace(sc.ice_cfg, dt_max=dt_max)
    sc.set_held_state(np.random.default_rng(3).uniform(0.5, 2.0,
                                                       (2, gr.nE)))
    return cp


def eager(cp):
    """``cp`` on the eager step: a plain wrapper of the SIA step is not
    fusible, so its sheets run ``_couple_core`` with the early exit."""
    from icebin_tpu_torch.models.ice_sheet import step_coupled

    def ice(*a):
        return step_coupled(*a)
    for sc in cp.sheets.values():
        sc.ice_step = ice
    return cp


@pytest.mark.parametrize("cfl", [False, True], ids=["30d", "cfl_bound"])
def test_graph_step_is_the_eager_step(cuda, cfl):
    """The compiled step (graph replays) against the eager _couple_core on
    the card: 5 stepwise steps then a fused run of 4, regenerating every 2
    (each regeneration rebinds the graphs), bit for bit every step's
    outputs, the state and every ledger row; a 5-year step whose CFL binds
    makes the budget rerun on the card."""
    year = 365.2425 * 86400.0
    kw = dict(dt=5 * year, dt_max=10 * year) if cfl else {}
    a, b = graph_toy(cuda, **kw), eager(graph_toy(cuda, **kw))
    sc = a.sheets["toy"]
    assert sc._fusible() and not b.sheets["toy"]._fusible()
    nE = a.gr.nE
    for k in range(5):
        f = torch.as_tensor(toy_forcing(nE, k), device=cuda)
        oa, ob = a.couple({"toy": f})["toy"], b.couple({"toy": f})["toy"]
        for key in ("fI", "fE_out", "fA_out"):
            assert same(oa[key], ob[key]), (k, key)

    def fn(t, sheet):
        return torch.as_tensor(toy_forcing(nE, int(t // a.cfg.dt)),
                               device=cuda)
    oa = a.run_transient(fn, 4, fused=True)["toy"]
    ob = b.run_transient(fn, 4)["toy"]
    for key in ("fI", "fE_out", "fA_out"):
        assert same(oa[key], ob[key]), key
    for k in ("H", "enth", "t"):
        assert torch.equal(getattr(sc.state, k),
                           getattr(b.sheets["toy"].state, k)), k
    assert a.ledger.to_rows() == b.ledger.to_rows()
    # the graphs are kept across the 4 regenerations: each rebinds them,
    # and a budget captures once
    assert sc.replays >= 9 and sc.regens_device == 5 and sc.rebinds == 4
    assert len(sc.capture_ms) == len(sc._graphs)
    assert (sc.reruns > 0) == cfl and (sc.budget > 1) == cfl


def test_graph_outputs_do_not_alias(cuda):
    """What a compiled step returned (fields, state) is unchanged by the
    next replay and shares no memory with the graph's static buffers, and
    the ledger row it booked stays as it was."""
    cp = graph_toy(cuda)
    sc = cp.sheets["toy"]
    f = [torch.as_tensor(toy_forcing(cp.gr.nE, k), device=cuda)
         for k in range(2)]
    out = cp.couple({"toy": f[0]})["toy"]
    state, row = sc.state, cp.ledger.to_rows()[-1]
    row0 = dict(row)
    kept = [out[k] for k in ("fI", "fE_out", "fA_out")] + [
        getattr(state, k) for k in ("H", "bed", "t", "enth")]
    copies = [x.clone() for x in kept]
    (g,) = sc._graphs.values()
    static = {x.data_ptr() for x in g.inputs + g.outputs}
    assert not static & {x.data_ptr() for x in kept}
    cp.couple({"toy": f[1]})
    assert sc.replays == 2
    for x, c in zip(kept, copies):
        assert same(x, c)
    assert row == row0 and cp.ledger.to_rows()[0] == row0


def test_graph_capture_failure_raises(cuda):
    """A fusible model that reads the card on the host cannot be captured:
    couple raises and nothing runs eagerly in its place (no step booked,
    the time and the state as they were)."""
    from icebin_tpu_torch.models.ice_sheet import step_coupled

    def reads_back(cfg, state, smb, tsurf, dt, enth_flux=None):
        if float(smb.sum()) < 0.0:          # a host read: no capture
            raise AssertionError("unreachable")
        return step_coupled(cfg, state, smb, tsurf, dt, enth_flux)

    reads_back.jittable = True
    cp = graph_toy(cuda)
    sc = cp.sheets["toy"]
    sc.ice_step = reads_back
    H0 = sc.state.H.clone()
    f = torch.as_tensor(toy_forcing(cp.gr.nE, 0), device=cuda)
    with pytest.raises(RuntimeError):
        cp.couple({"toy": f})
    assert sc.replays == 0 and sc.steps_since_regen == 0
    assert torch.equal(sc.state.H, H0)
    assert cp.ledger.to_rows() == [] and cp.time == 0.0
    # the card is still usable: the SIA step captures and runs
    sc.ice_step = step_coupled
    cp.couple({"toy": f})
    assert sc.replays == 1 and len(cp.ledger.to_rows()) == 1


# -- regeneration on the card ----------------------------------------------

def test_segment_sum_kernel_is_its_plain_version(cuda):
    """Empty, short and 100,000-long segments of terms whose large parts
    cancel: the kernel's sums are the plain version's bit for bit."""
    from icebin_tpu_torch.ops.segsum import segment_sum, segment_sum_ref
    rng = np.random.default_rng(23)
    lens = np.concatenate([rng.integers(0, 4, 200_000), [100_000, 0, 7],
                           rng.integers(0, 300, 2_000)])
    rng.shuffle(lens)
    ptr = torch.as_tensor(np.concatenate([[0], np.cumsum(lens)]))
    n = int(ptr[-1])
    vals = torch.as_tensor(rng.standard_normal(n)
                           * 10.0 ** rng.integers(-3, 12, n))
    segment_sum.launches = 0
    got = segment_sum(vals.to(cuda), ptr.to(cuda))
    torch.cuda.synchronize()
    assert segment_sum.launches == 1
    assert same(got.cpu(), segment_sum_ref(vals, ptr))
    empty = segment_sum(vals[:0].to(cuda), ptr[:1].to(cuda))
    assert empty.shape == (0,)


def dome_masks(specI, seed=29):
    """A dome over the lattice's inner disc (NaN outside), and the next
    generation's: a seeded fifth of its ice gone, the rest 37.5 m higher."""
    x = 0.5 * (specI.xb[1:] + specI.xb[:-1])
    y = 0.5 * (specI.yb[1:] + specI.yb[:-1])
    X, Y = np.meshgrid((x - x.mean()) / np.ptp(x), (y - y.mean()) / np.ptp(y))
    r = np.hypot(X, Y) / 0.45
    m0 = np.where(r < 1.0, 3600.0 * np.sqrt(np.clip(1 - r, 0, 1)) - 40.0,
                  np.nan).reshape(-1)
    iced = np.flatnonzero(np.isfinite(m0))
    m1 = m0 + 37.5
    m1[np.random.default_rng(seed).choice(iced, len(iced) // 5,
                                          replace=False)] = np.nan
    return m0, m1


def test_regeneration_on_the_card_is_the_host_factory(cuda):
    """Antarctica at 5 km (its exchange grid clipped on the card): the
    device factory's EvI/AvI packs (both CSRs, the live rows, the f64
    weights), E1vE0 between two generations, the EC measure, fhc and elevE
    are the host factory's bit for bit, and the pack's row and column sums
    through the kernel its plain version's."""
    import icebin_tpu_torch as port
    from icebin_tpu_torch.coupler.e1ve0 import e1ve0_matrix
    from icebin_tpu_torch.ops.csr import csr_pack_sorted
    from icebin_tpu_torch.ops.segsum import segment_sum, segment_sum_ref
    from icebin_tpu_torch.regrid.device import (DeviceExchange,
                                                DeviceRegridMatrices,
                                                e1ve0_device)
    from icebin_tpu_torch.regrid.matrices import RegridParams
    from icebin_tpu_torch.tools.common import (HCDEFS, antarctica_spec,
                                               greenland_specs)
    specA, _ = greenland_specs()
    specI = antarctica_spec()
    gr = port.GCMRegridder(specA, HCDEFS, device=cuda)
    gr.add_sheet("antarctica", specI, subdiv=2)
    xd = DeviceExchange(gr, "antarctica", cuda)
    assert xd.iA.numel() > 1_000_000
    m0, m1 = dome_masks(specI)
    h0, h1 = (gr.regrid_matrices("antarctica", m, smooth=False)
              for m in (m0, m1))
    d0, d1 = (DeviceRegridMatrices(xd, torch.as_tensor(m, device=cuda))
              for m in (m0, m1))

    def bits(a, b, what):
        a, b = (torch.as_tensor(np.ascontiguousarray(x)) if isinstance(
            x, np.ndarray) else x.cpu() for x in (a, b))
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert (same(a, b) if a.is_floating_point()
                else torch.equal(a, b)), what

    P = RegridParams()
    segment_sum.launches = 0
    for name in ("EvI", "AvI"):
        ph = csr_pack(h1.matrix(name, P), nv=16, device=cuda)
        rows, cols, vals, shape = d1.coo(name, P)
        pd = csr_pack_sorted(rows, cols, vals, shape, nv=16)
        for side in ("small", "ice"):
            a, b = getattr(ph, side), getattr(pd, side)
            for k in ("rowptr", "cols", "vals", "winv", "live"):
                bits(getattr(a, k), getattr(b, k), f"{name} {side} {k}")
            assert a.n_live == b.n_live
        bits(ph.wS, pd.wS, f"{name} wS")
        bits(ph.wI, pd.wI, f"{name} wI")
        ptr = torch.searchsorted(rows, torch.arange(shape[0] + 1,
                                                    device=cuda))
        bits(segment_sum(vals, ptr), segment_sum_ref(vals.cpu(), ptr.cpu()),
             f"{name} row sums through the kernel")
    assert segment_sum.launches > 0
    a, b = e1ve0_matrix(h0, h1), e1ve0_device(d0, d1)
    assert a.nnz == b.nnz > 0
    for k in ("rows", "cols", "vals", "wM", "Mw"):
        bits(getattr(a, k), getattr(b, k), f"E1vE0 {k}")
    for k in ("ec_weights", "fhc", "elevE"):
        bits(getattr(h1, k)(), getattr(d1, k)(), k)


def test_recaptures_reuse_their_memory(cuda):
    """Twelve windows, each ending in a regeneration: the graph is kept
    and rebound, not captured again, and the new packs are loaded into the
    buffers it reads, so one capture serves them all and the card's
    reserved memory does not grow after the first window (a new capture,
    stream and pool a generation grew it until a capture ran out of
    memory)."""
    cp = graph_toy(cuda)
    sc = cp.sheets["toy"]
    fE = torch.as_tensor(toy_forcing(cp.gr.nE, 0), device=cuda)
    reserved = []
    for _ in range(12):
        cp.run_transient(lambda t, s: fE, 2, fused=True)
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved(cuda))
    assert sc.regens_device == 13 and len(sc.capture_ms) == 1
    assert sc.rebinds == 12 and list(sc._graphs) == [sc.budget]
    assert reserved[1:] == [reserved[1]] * 11, reserved


def test_rebound_graph_is_a_fresh_capture(cuda):
    """Six generations from set masks, a window of 2 steps each: the
    sheet that keeps its graph is bit for bit one that captures it afresh
    every generation (the window's rows, last outputs and the state),
    across rebinds where EvI's dest-small warps change (2 and 1 at the
    level and spread masks); a generation with no ice (no live row: no
    dest-small launch) and the one after it capture again."""
    from icebin_tpu_torch.coupler.coupler import IceSheetCoupler
    from icebin_tpu_torch.ops.apply import small_geometry

    class Fresh(IceSheetCoupler):
        def _rebind_graphs(self):
            self._stale.update(self._graphs)

    cp = graph_toy(cuda)
    a = cp.sheets["toy"]
    b = Fresh(cp.gr, "toy", cp.cfg, device=cuda)
    nI, nE = cp.gr.sheets["toy"].specI.ncells, cp.gr.nE
    rng = np.random.default_rng(3)
    masks = {"level": np.full(nI, 750.0),
             "spread": rng.uniform(0.0, 2000.0, nI),
             "bare": np.full(nI, np.nan)}
    fE = torch.stack([torch.as_tensor(toy_forcing(nE, k), device=cuda)
                      for k in range(2)])
    warps = []
    for name in ("spread", "level", "spread", "bare", "level", "spread"):
        for sc in (a, b):
            sc.regen_matrices(elevmask=masks[name])
        small = [a.mat(n).pack.small for n in ("EvI", "AvI")]
        warps.append(tuple(small_geometry(c, 10)[0] * (c.n_live > 0)
                           for c in small))
        (ra, la), (rb, lb) = a.couple_window(fE), b.couple_window(fE)
        assert ra.tobytes() == rb.tobytes(), name
        for key in ("fI", "fE_out", "fA_out"):
            assert same(la[key], lb[key]), (name, key)
        for k in ("H", "enth", "t"):
            assert torch.equal(getattr(a.state, k), getattr(b.state, k)), k
    assert warps[:3] == [(1, 2), (2, 2), (1, 2)] and warps[3] == (0, 0)
    assert a.rebinds == 3 and len(a.capture_ms) == 3
    assert b.rebinds == 0 and len(b.capture_ms) == 6
    assert a.replays == b.replays == 12
