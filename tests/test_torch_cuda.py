"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU (sm_90a) and nvcc; without a card they skip.
This file imports no JAX, so on a machine without JAX run it without the
suite's conftest:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_cuda.py

Tolerances: the spmm kernels and their plain version both sum in f64 and
round once to f32, so they agree to one f32 ulp of the output; the clip
kernel sums its compacted ring's shoelace in f64 where the plain version
sums 16 * V0 slots in f32, so areas agree to 1e-5 of the ring's scale.
"""
import numpy as np
import pytest
import torch

from icebin_tpu.regrid.sparse import WeightedMatrix

from icebin_tpu_torch.ops.apply import (apply_ice, apply_small, spmm_dest_ice,
                                        spmm_dest_small, spmm_ref)
from icebin_tpu_torch.ops.clip import (clip_areas_centroids,
                                       clip_areas_centroids_ref)
from icebin_tpu_torch.ops.csr import csr_pack

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
