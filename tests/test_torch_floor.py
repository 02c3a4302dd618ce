"""The plain versions of the stream-only floors (icebin_tpu_torch.ops.floor),
which the CUDA floors of csrc/floor.cu are held to bit for bit on the card
(tests/test_torch_cuda.py), against an independent numpy evaluation of
their stated definition

    out[r, v] = winv[r] + sum_{k in row r} (vals[k] + x[cols[k], v])

in f32, in the kernels' fixed order (ops/floor.py's docstring): scalar
np.float32 loops, row by row and lane by lane, on seeded CSRs with empty
rows and rows longer than a warp, at nv in {1, 16, 20, 64}.  Both sides
round the same f32 operations in the same order, so they agree bit for bit.

Then the floor is a checksum of everything the stock kernel reads:
perturbing any vals[k], winv[r] or source value the matrix reads changes
the output, and a source row the matrix does not read leaves it unchanged.
"""
import numpy as np
import pytest
import torch

from icebin_tpu_torch.ops.csr import csr_from_coo
from icebin_tpu_torch.ops.floor import (spmm_floor_ice, spmm_floor_ice_ref,
                                        spmm_floor_small,
                                        spmm_floor_small_ref)

torch.set_num_threads(1)

CPU = torch.device("cpu")
FLOORS = ((spmm_floor_small, spmm_floor_small_ref),
          (spmm_floor_ice, spmm_floor_ice_ref))


def seeded_csr(seed, n_dst=12, n_src=90, long_rows=(45, 70)):
    """COO with empty rows (0, 5, the last), rows of ``long_rows`` > 32
    nonzeros (3 and 7) and rows of 1-6; source rows n_src - 5.. are never
    read."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 7, n_dst)
    lens[[0, 5, n_dst - 1]] = 0
    lens[[3, 7]] = long_rows
    dst = np.repeat(np.arange(n_dst), lens)
    src = np.concatenate([rng.choice(n_src - 5, n, replace=False)
                          for n in lens])
    vals = rng.uniform(0.5, 1.5, len(dst))
    w = rng.uniform(0.5, 2.0, n_dst)
    return csr_from_coo(dst, src, vals, n_dst, n_src, w, device=CPU)


def numpy_floor(csr, x, small):
    """The definition, scalar by scalar in np.float32 (module docstring)."""
    rowptr, cols = csr.rowptr.numpy(), csr.cols.numpy()
    vals, winv = csr.vals.numpy(), csr.winv.numpy()
    out = np.zeros((csr.n_dst, x.shape[1]), np.float32)
    for r in range(csr.n_dst):
        k0, k1 = rowptr[r], rowptr[r + 1]
        for v in range(x.shape[1]):
            def term(k):
                return np.float32(vals[k] + x[cols[k], v])
            if small:
                lane = [np.float32(0.0)] * 32
                for k in range(k0, k1):
                    lane[(k - k0) % 32] = np.float32(lane[(k - k0) % 32]
                                                     + term(k))
                off = 16
                while off:
                    for j in range(off):
                        lane[j] = np.float32(lane[j] + lane[j + off])
                    off //= 2
                total = lane[0]
            else:
                total = np.float32(0.0)
                for k in range(k0, k1):
                    total = np.float32(total + term(k))
            out[r, v] = np.float32(total + winv[r])
    return out


@pytest.mark.parametrize("nv", [1, 16, 20, 64])
def test_plain_floors_are_their_definition(nv):
    csr = seeded_csr(nv)
    x = np.random.default_rng(100 + nv).uniform(
        -1.0, 2.0, (csr.n_src, nv)).astype(np.float32)
    xt = torch.as_tensor(x)
    for (wrap, ref), small in zip(FLOORS, (True, False)):
        got = ref(csr, xt)
        assert got.dtype == torch.float32 and got.shape == (csr.n_dst, nv)
        np.testing.assert_array_equal(got.numpy(), numpy_floor(csr, x, small))
        # empty rows are winv alone
        assert torch.equal(got[0], csr.winv[0].expand(nv))
        # on CPU tensors the wrapper is the plain version, and no kernel runs
        n0 = wrap.launches
        assert torch.equal(wrap(csr, xt), got)
        assert wrap.launches == n0
    # the two orders differ somewhere: each plain version is its own kernel's
    small, ice = (ref(csr, xt) for _, ref in FLOORS)
    if nv >= 16:
        assert not torch.equal(small, ice)


def test_floor_reads_everything_the_kernel_reads():
    csr = seeded_csr(7)
    nv = 3
    x = np.random.default_rng(8).uniform(0.5, 1.5, (csr.n_src, nv)
                                         ).astype(np.float32)
    read = set(csr.cols.tolist())
    assert len(read) < csr.n_src                      # some rows unread
    for _, ref in FLOORS:
        base = ref(csr, torch.as_tensor(x))

        def changed(c=None, xx=None):
            out = ref(c or csr, torch.as_tensor(x if xx is None else xx))
            return not torch.equal(out, base)

        for k in range(csr.vals.numel()):
            vals = csr.vals.clone()
            vals[k] += 0.5
            assert changed(c=type(csr)(**{**csr.__dict__, "vals": vals})), k
        for r in range(csr.n_dst):
            winv = csr.winv.clone()
            winv[r] += 0.5
            assert changed(c=type(csr)(**{**csr.__dict__, "winv": winv})), r
        for s in range(csr.n_src):
            for v in range(nv):
                xx = x.copy()
                xx[s, v] += 0.5
                assert changed(xx=xx) == (s in read), (s, v)


def test_floor_wrappers_check_operands():
    csr = seeded_csr(1)
    x = torch.ones((csr.n_src, 4))
    for wrap, _ in FLOORS:
        for bad in (x.double(), x[:-1], x.t().contiguous(), x[:, ::2]):
            with pytest.raises(ValueError):
                wrap(csr, bad)
