"""The port's stream-reduce (icebin_tpu_torch.ops.roof) against the
reference's Pallas body ``_sum_kernel`` (tools/probe_stream_scale.py:40),
run through ``pl.pallas_call(..., interpret=True)`` on the CPU at a small
shape, and against an f64 sum.

Tolerance: both sides sum f32 values in f32, in different orders (the
Pallas kernel block by block over the sequential grid, PyTorch pairwise),
so they agree to a few f32 roundings of sum |x|: 1e-6 of it.  The CUDA
kernel itself needs the card (tests/test_torch_cuda.py).
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from icebin_tpu_torch.ops.roof import stream_reduce, stream_reduce_ref

torch.set_num_threads(1)

TOL = 1e-6
ROOT = Path(__file__).resolve().parents[1]


def probe_module():
    """tools/probe_stream_scale.py, loaded from its file (tools/ is not a
    package); it defines functions only."""
    path = ROOT / "tools" / "probe_stream_scale.py"
    spec = importlib.util.spec_from_file_location("probe_stream_scale", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def pallas_stream(x, c, bs):
    """The reference's carried stream-reduce: its kernel body, its grid over
    row blocks of ``bs`` and (32, 128) tiles, in interpret mode."""
    nrows = x.shape[0]
    fn = pl.pallas_call(
        probe_module()._sum_kernel,
        grid=(nrows // bs,),
        in_specs=[pl.BlockSpec((bs, 32, 128), lambda i: (i, 0, 0)),
                  pl.BlockSpec((32, 128), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((32, 128), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((32, 128), jnp.float32),
        interpret=True)
    return np.asarray(fn(jnp.asarray(x), jnp.asarray(c)))


@pytest.mark.parametrize("nrows,bs", [(16, 4), (24, 8)])
def test_stream_reduce_matches_pallas_kernel(nrows, bs):
    rng = np.random.default_rng(nrows)
    x = rng.uniform(-1.0, 1.0, (nrows, 32, 128)).astype(np.float32)
    c = rng.uniform(-1.0, 1.0, (32, 128)).astype(np.float32)
    want = pallas_stream(x, c, bs)
    xt = torch.as_tensor(x.reshape(nrows, -1))
    ct = torch.as_tensor(c.reshape(-1))
    got = stream_reduce(xt, ct).numpy().reshape(32, 128)
    assert torch.equal(stream_reduce(xt, ct), stream_reduce_ref(xt, ct))
    scale = np.abs(x).sum(0) + np.abs(c)
    assert np.max(np.abs(got - want) / scale) < TOL
    exact = c.astype(np.float64) + x.astype(np.float64).sum(0)
    assert np.max(np.abs(got - exact) / scale) < TOL


def test_stream_reduce_without_carry_and_checks():
    """No ``c`` is a zero carry (bench_roof.py's column sums); the wrapper
    rejects what the kernel does not take, on the CPU too."""
    x = torch.as_tensor(np.random.default_rng(0).uniform(
        -1.0, 1.0, (300, 128)).astype(np.float32))
    assert torch.equal(stream_reduce(x), x.sum(0))
    for bad in (x.double(), x[:, :6], x.t(), x[:0], x[0]):
        with pytest.raises(ValueError):
            stream_reduce(bad)
    with pytest.raises(ValueError):
        stream_reduce(x, torch.zeros(64))
