"""The plain version of the on-chip capacity probe
(icebin_tpu_torch.ops.smemprobe), which the CUDA kernels of
csrc/smemprobe.cu are held to on the card (tests/test_torch_cuda.py),
against the body ``k`` of the reference's VMEM probe tools/probe_vmem.py,
rebuilt as a ``pl.pallas_call(..., interpret=True)`` with the probe's VMEM
block specs, bit for bit (x * 2 is exact in f32); and the bisect's logic
with an injected attempt in place of the card.
"""
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from icebin_tpu_torch.ops import smemprobe as sm

ROOT = Path(__file__).resolve().parents[1]


def probe_body():
    """The body ``k`` of tools/probe_vmem.py (nested in ``main.try_mb``),
    rebuilt from the file's compiled code, without running the probe."""
    path = ROOT / "tools" / "probe_vmem.py"
    code = compile(path.read_text(), str(path), "exec")
    for name in ("main", "try_mb", "k"):
        code = next(c for c in code.co_consts
                    if isinstance(c, types.CodeType) and c.co_name == name)
    assert code.co_freevars == ()
    return types.FunctionType(code, {}, "k")


def pallas_k(x):
    """``try_mb``'s pallas_call on the whole (n, 128) array in VMEM, here in
    interpret mode."""
    fn = pl.pallas_call(
        probe_body(),
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        compiler_params=pltpu.CompilerParams(
            vmem_limit_bytes=256 * 1024 * 1024),
        interpret=True)
    return np.array(fn(jnp.asarray(x)))


@pytest.mark.parametrize("n", [8, 224])
def test_plain_copy_matches_pallas_body(n):
    for x in (np.ones((n, sm.COLS), np.float32),      # the probe's input
              sm.rows_data(n, "cpu").numpy()):
        want = pallas_k(x)
        xt = torch.as_tensor(x)
        for scope, cluster in (("block", 1), ("cluster", 16)):
            n0 = sm.smem_copy.launches
            got = sm.smem_copy(xt, scope, cluster)
            assert sm.smem_copy.launches == n0        # CPU: plain version
            assert np.array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


def threshold(rows, refusal="cudaErrorInvalidValue", occupancy=1):
    """An attempt that accepts up to ``rows`` rows and refuses above."""
    def run(n):
        return ("cudaSuccess", occupancy) if n <= rows else (refusal, 0)
    return run


def test_bisect_finds_the_block_limit():
    found = sm.largest_rows("block", 1,
                            attempt_fn=threshold(227, occupancy=None))
    assert found["rows"] == 227 and found["refused_rows"] == 228
    assert found["refusal"] == "cudaErrorInvalidValue"
    assert found["occupancy"] is None
    # fewer launches than sizes: the bisect halves the interval
    assert found["attempts"] < 20


@pytest.mark.parametrize("cluster", sm.CLUSTERS)
def test_bisect_finds_the_cluster_limit(cluster):
    for refusal in ("cudaErrorInvalidConfiguration", sm.NO_CLUSTER,
                    "cudaErrorInvalidClusterSize"):
        found = sm.largest_rows("cluster", cluster,
                                attempt_fn=threshold(cluster * 227, refusal,
                                                     occupancy=132 // cluster))
        assert found["rows"] == cluster * 227
        assert found["refused_rows"] == cluster * 227 + 1
        assert found["refusal"] == refusal
        assert found["occupancy"] == 132 // cluster
        assert found["refusal_occupancy"] == 0   # as the attempt says


def test_bisect_below_its_first_size_and_nothing():
    assert sm.largest_rows(attempt_fn=threshold(5))["rows"] == 5
    with pytest.raises(RuntimeError, match="even 1 row"):
        sm.largest_rows(attempt_fn=threshold(0))


def test_bisect_raises_on_a_status_that_is_no_refusal():
    for status in ("cudaErrorIllegalAddress", "cudaErrorLaunchFailure",
                   "cudaErrorMemoryAllocation"):
        with pytest.raises(RuntimeError, match="not a launch-configuration"):
            sm.largest_rows(attempt_fn=threshold(227, status))


def test_smem_copy_checks_operands():
    x = sm.rows_data(4, "cpu")
    assert torch.equal(sm.smem_copy(x, "cluster", 4), x * 2.0)
    for arg, scope, cluster in ((x, "block", 2), (x, "cluster", 1),
                                (x, "cluster", 3), (x, "cluster", 32),
                                (x, "grid", 1), (x.double(), "block", 1),
                                (x[:, :64], "block", 1), (x[:0], "block", 1),
                                (x.t(), "block", 1), (x[0], "block", 1)):
        with pytest.raises(ValueError):
            sm.smem_copy(arg, scope, cluster)
