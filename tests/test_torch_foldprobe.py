"""The plain versions of the fold probe (icebin_tpu_torch.ops.foldprobe),
which the CUDA kernel of csrc/foldprobe.cu is held to on the card
(tests/test_torch_cuda.py), against the six bodies of the reference's
Mosaic fold probe tools/probe_fold_ops.py, each rebuilt as a
``pl.pallas_call(..., interpret=True)`` with the probe's VMEM block specs and
run on the probe's own seeded inputs, and against numpy's permutations in
f64.  A fold is a permutation: every comparison is bit for bit.
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

from icebin_tpu_torch.ops.foldprobe import (FOLDS, ROUTES, fold_tiles,
                                            fold_tiles_ref, shapes)
from icebin_tpu_torch.tools import probe_fold_ops

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def probe_body(name):
    """The body ``name`` of tools/probe_fold_ops.py's ``main`` (nested
    there), rebuilt as a function from the file's compiled code, without
    running the probe."""
    path = ROOT / "tools" / "probe_fold_ops.py"
    code = compile(path.read_text(), str(path), "exec")
    main = next(c for c in code.co_consts
                if isinstance(c, types.CodeType) and c.co_name == "main")
    body = next(c for c in main.co_consts
                if isinstance(c, types.CodeType) and c.co_name == name)
    assert body.co_freevars == ()
    return types.FunctionType(body, {"jnp": jnp}, name)


def pallas_fold(name, x, out_shape):
    """The probe's ``run``: its pallas_call on whole arrays in VMEM, here
    in interpret mode."""
    fn = pl.pallas_call(
        probe_body(name),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32),
        interpret=True)
    return np.asarray(fn(jnp.asarray(x)))


def probe_inputs():
    """x328, x464 and x_big as the probe's ``main`` draws them."""
    rng = np.random.default_rng(0)
    x328 = jnp.asarray(rng.uniform(-1, 1, (32, 8)), jnp.float32)
    x464 = jnp.asarray(rng.uniform(-1, 1, (4, 64)), jnp.float32)
    x_big = jnp.asarray(rng.uniform(-1, 1, (64, 32, 8)), jnp.float32)
    return {"x328": np.array(x328), "x464": np.array(x464),
            "x_big": np.array(x_big)}


def test_probe_tool_draws_the_probes_inputs():
    """tools/probe_fold_ops.tiles gives the TPU probe's inputs at B = 1 and
    64, in its order."""
    want = probe_inputs()
    a1, b1 = probe_fold_ops.tiles(1)
    a64, b64 = probe_fold_ops.tiles(64)
    assert np.array_equal(a1[0], want["x328"])
    assert np.array_equal(b1[0], want["x464"])
    assert np.array_equal(a64, want["x_big"])
    assert b64.shape == (64, 4, 64) and b64.dtype == np.float32


BODIES = [  # body, its input, its output shape, the port's fold
    ("k_reshape_down", "x328", (4, 64), "reshape_down"),
    ("k_reshape_up", "x464", (32, 8), "reshape_up"),
    ("k_subslice_concat", "x328", (4, 64), "v1_fold"),
    ("k_laneslice_concat", "x464", (32, 8), "v1_unfold"),
    ("k_block_fold", "x_big", (64, 4, 64), "v1_fold"),
    ("k_block_reshape", "x_big", (64, 4, 64), "reshape_down"),
]


@pytest.mark.parametrize("body,arg,out_shape,fold", BODIES,
                         ids=[b[0] for b in BODIES])
def test_plain_fold_matches_pallas_body(body, arg, out_shape, fold):
    x = probe_inputs()[arg]
    want = pallas_fold(body, x, out_shape)
    xt = torch.as_tensor(x if x.ndim == 3 else x[None])
    for route in ROUTES:
        n0 = fold_tiles.launches
        got = fold_tiles(xt, fold, route)
        assert fold_tiles.launches == n0               # CPU: plain version
        assert torch.equal(got, fold_tiles_ref(xt, fold))
        assert np.array_equal(got.numpy().reshape(want.shape), want)


def numpy_fold(x, fold):
    """``fold`` of each tile of x by index arithmetic, as the module
    docstring states it."""
    B = x.shape[0]
    if fold == "reshape_down":
        return x.reshape(B, 4, 64)
    if fold == "reshape_up":
        return x.reshape(B, 32, 8)
    t, r, v = np.meshgrid(np.arange(4), np.arange(8), np.arange(8),
                          indexing="ij")
    out = np.empty((B, 4, 64) if fold == "v1_fold" else (B, 32, 8))
    if fold == "v1_fold":
        out[:, t, 8 * r + v] = x[:, 4 * r + t, v]
    else:
        out[:, 4 * r + t, v] = x[:, t, 8 * r + v]
    return out


@pytest.mark.parametrize("fold", FOLDS)
def test_plain_fold_f64_is_the_permutation(fold):
    shape = shapes(fold)[0]
    x = np.random.default_rng(5).uniform(-1, 1, (5, *shape))
    got = fold_tiles(torch.as_tensor(x), fold, "smem")
    assert got.dtype == torch.float64
    assert tuple(got.shape[1:]) == shapes(fold)[1]
    assert np.array_equal(got.numpy(), numpy_fold(x, fold))


def test_folds_invert_and_differ():
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.uniform(-1, 1, (3, 32, 8)))
    for down, up in (("v1_fold", "v1_unfold"),
                     ("reshape_down", "reshape_up")):
        assert torch.equal(fold_tiles(fold_tiles(x, down, "shfl"), up,
                                      "shfl"), x)
    assert not torch.equal(fold_tiles(x, "reshape_down", "smem"),
                           fold_tiles(x, "v1_fold", "smem"))
    # the V1 fold keeps row 4 r + t's eight values together
    out = fold_tiles(x, "v1_fold", "smem")
    assert torch.equal(out[:, 1, 16:24], x[:, 9])


def test_fold_tiles_checks_operands():
    a = torch.zeros((2, 32, 8))
    b = torch.zeros((2, 4, 64))
    assert fold_tiles(a, "v1_fold", "smem").shape == (2, 4, 64)
    assert fold_tiles(b, "v1_unfold", "shfl").shape == (2, 32, 8)
    assert fold_tiles(a[:0], "reshape_down", "smem").shape == (0, 4, 64)
    for x, fold, route in ((b, "v1_fold", "smem"), (a, "v1_unfold", "smem"),
                           (a.half(), "v1_fold", "smem"),
                           (a.int(), "v1_fold", "smem"),
                           (a[0], "v1_fold", "smem"),
                           (torch.zeros((2, 8, 32)).transpose(1, 2),
                            "v1_fold", "smem"),
                           (a, "v2_fold", "smem"), (a, "v1_fold", "regs")):
        with pytest.raises(ValueError):
            fold_tiles(x, fold, route)


def test_probe_cases_on_the_cpu():
    """tools/probe_fold_ops.run_cases without timing: every case bit for
    bit its plain version, the library copy and its rerun; the TPU probe's
    semantic checks as the probe prints them."""
    cases = probe_fold_ops.run_cases((1, 3), torch.device("cpu"), reps=0)
    assert len(cases) == 2 * 2 * len(FOLDS) * len(ROUTES)
    for c in cases:
        assert c["equals_plain"] and c["equals_library"], c
        assert c["rerun_identical"] and c["max_abs_err"] == 0.0
        assert c["ms"] is None and c["launches"] is None
        assert c["MB"] == 2 * 256 * c["blocks"] * (
            4 if c["dtype"] == "f32" else 8) / 1e6
    assert probe_fold_ops.semantic_checks(torch.device("cpu")) == {
        "reshape matches row-major fold": True,
        "slice+concat matches row-major fold": False,
        "slice+concat == V1 fold": True}
