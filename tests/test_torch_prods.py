"""The plain version of the batched tile product (icebin_tpu_torch.ops.prods),
which the CUDA kernel of csrc/prods.cu is held to on the card
(tests/test_torch_cuda.py), against the reference's Pallas body ``kernel``
of tools/probe_prods_scale.py at ``passes=3`` (the 3-pass split-bf16
product), rebuilt as a ``pl.pallas_call(..., interpret=True)`` with the
probe's grid and block shapes at small depths, and against an f64 product.

Tolerances, of sum_c |T * F| per output:
* against the Pallas body: 2**-15.  Its split drops the lo * lo term and
  rounds each lo part to bf16 (about 2**-16), and each side's f32
  accumulation of 128 terms adds at most 128 * 2**-24 = 2**-17.
* against the f64 product: 2**-23, the plain version's one rounding to
  f32.
"""
import functools
import importlib.util
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from icebin_tpu_torch.ops.prods import tile_prods, tile_prods_ref

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def probe_body(passes=3):
    """The body ``kernel`` of tools/probe_prods_scale.py's ``mk_prods``
    (nested there, closing over ``passes``), rebuilt as a function with
    ``passes`` bound; the probe is loaded from its file, as
    tests/test_torch_roof.py loads its probe."""
    path = ROOT / "tools" / "probe_prods_scale.py"
    spec = importlib.util.spec_from_file_location("probe_prods_scale", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    code = next(c for c in mod.mk_prods.__code__.co_consts
                if isinstance(c, types.CodeType) and c.co_name == "kernel")
    assert code.co_freevars == ("passes",)
    return types.FunctionType(code, vars(mod), "kernel", None,
                              (types.CellType(passes),))


def pallas_prods(t, f, bs):
    """The probe's pallas_call (grid over row blocks of ``bs``, blocks
    (bs, 32, 128), (bs, 8, 128) -> (bs, 32, 8)) in interpret mode."""
    nrows = t.shape[0]
    fn = pl.pallas_call(
        functools.partial(probe_body(), bs),
        grid=(nrows // bs,),
        in_specs=[pl.BlockSpec((bs, 32, 128), lambda i: (i, 0, 0)),
                  pl.BlockSpec((bs, 8, 128), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((bs, 32, 8), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((nrows, 32, 8), jnp.float32),
        interpret=True)
    return np.asarray(fn(jnp.asarray(t), jnp.asarray(f)))


@pytest.mark.parametrize("nrows,bs", [(16, 4), (24, 8)])
def test_tile_prods_matches_pallas_kernel(nrows, bs):
    rng = np.random.default_rng(nrows)
    t = rng.uniform(-1.0, 1.0, (nrows, 32, 128)).astype(np.float32)
    f = rng.uniform(-1.0, 1.0, (nrows, 8, 128)).astype(np.float32)
    want = pallas_prods(t, f, bs)
    tt, ft = torch.as_tensor(t), torch.as_tensor(f)
    n0 = tile_prods.launches
    got = tile_prods(tt, ft)
    assert tile_prods.launches == n0                  # CPU: plain version
    assert torch.equal(got, tile_prods_ref(tt, ft))
    got = got.numpy().astype(np.float64)
    t64, f64 = t.astype(np.float64), f.astype(np.float64)
    mag = np.einsum("bic,bjc->bij", np.abs(t64), np.abs(f64))
    assert np.max(np.abs(got - want) / mag) < 2.0 ** -15
    exact = np.einsum("bic,bjc->bij", t64, f64)
    assert np.max(np.abs(got - exact) / mag) <= 2.0 ** -23
    # the split product is not exact: the bound above is not vacuous
    assert np.max(np.abs(want - exact) / mag) > 2.0 ** -23


def test_tile_prods_checks_operands():
    T = torch.zeros((4, 32, 128))
    F = torch.zeros((4, 8, 128))
    assert tile_prods(T, F).shape == (4, 32, 8)
    for bad_t, bad_f in ((T.double(), F), (T, F[:3]), (T[:, :16], F),
                         (T, F.transpose(1, 2).contiguous()),
                         (T.transpose(1, 2), F), (T[0], F)):
        with pytest.raises(ValueError):
            tile_prods(bad_t, bad_f)
