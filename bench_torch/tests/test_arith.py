"""The harness's own arithmetic at toy sizes: rate and tail, the regrid
bound, the trace reduction, the seeded inputs, and what it imports."""
import ast
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from harness import common, drivers

BENCH = Path(__file__).resolve().parent.parent


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_rate_and_tail_move_with_one_stall():
    steady = drivers.Run(steps=20, window_s=2.0, step_s=[0.1] * 20)
    stall = drivers.Run(steps=20, window_s=4.0,
                        step_s=[0.1] * 10 + [2.1] + [0.1] * 9)
    rate, tail = reader("steps_per_s"), reader("step_ms_p95")
    assert reader("oneway_steps_per_s")(stall) == rate(stall)
    assert rate(steady) == pytest.approx(10.0)
    assert rate(stall) == pytest.approx(5.0)
    assert tail(steady) == pytest.approx(100.0)
    # 0.95 of the way through 20 sorted steps lies 5% into the last gap
    assert tail(stall) == pytest.approx(100.0 + 0.05 * 2000.0)
    assert tail(drivers.Run()) is None


def test_roofline_bytes_match_the_programs_count():
    from icebin_tpu_torch.ops.csr import csr_from_coo
    from icebin_tpu_torch.utils.profiling import csr_apply_bytes
    rng = np.random.default_rng(0)
    dst = rng.integers(0, 50, 400)
    src = rng.integers(0, 300, 400)
    csr = csr_from_coo(dst, src, rng.uniform(0.1, 1.0, 400), 50, 300,
                       np.ones(50), device="cpu")
    used = torch.unique(csr.cols).numel()
    for nv in (1, 8, 10, 16):
        assert common.apply_bytes(csr.n_dst, 400, used, nv) == \
            csr_apply_bytes(csr, nv)
        b = csr_apply_bytes(csr, nv)
        assert common.csr_bound_s(csr, nv) == max(
            b / common.PEAK_BYTES_S, 2 * 400 * nv / common.PEAK_F32_FLOP_S)


def test_trace_reduction():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0)]
    assert common.union_s(iv) == 4.0
    assert common.gaps(iv, 0.0, 8.0) == [(3.0, 5.0), (6.0, 8.0)]

    class E:
        def __init__(self, name, s, e, dev):
            self.name = name
            self.device_type = (torch.autograd.DeviceType.CUDA if dev
                                else torch.autograd.DeviceType.CPU)
            self.time_range = type("R", (), {"start": s, "end": e})()
    ev = [E("void dest_ice_kernel<4>", 0, 10, True),
          E("void dest_small_kernel<float>", 10, 30, True),
          E("reduce_kernel<ReduceOp<double>>", 40, 50, True),
          E("bench.topo", 30, 40, False), E("bench.step", 0, 100, False)]
    tr = common.Trace(ev, 100e-6, 1)
    assert tr.busy_s == pytest.approx(40e-6)
    assert tr.kernel_s("reduce_kernel", "double") == (pytest.approx(10e-6),
                                                      1)
    gaps = dict(tr.idle_gaps())
    assert gaps["topo"] == pytest.approx(10e-6)
    assert gaps["step"] == pytest.approx(50e-6)
    # the window: 50 steps in 10 ms, so 0.2 ms a step of which 0.04 busy
    run = drivers.Run(trace=tr, spmm_bound_s=15e-6, n_sheets=1, steps=50,
                      window_s=0.01)
    for tail in ("", ".oneway"):
        assert reader("spmm.roofline_pct" + tail)(run) == \
            pytest.approx(50.0)
        assert reader("device.idle_pct" + tail)(run) == pytest.approx(80.0)
        assert reader("reduce.us_per_step" + tail)(run) == \
            pytest.approx(10.0)
        assert reader("device.busy_ms_per_step" + tail)(run) == \
            pytest.approx(0.04)
        assert reader("spmm.roofline_pct" + tail)(drivers.Run()) is None
        assert reader("device.idle_pct" + tail)(drivers.Run()) is None


def test_the_sample_always_holds_the_first_period():
    for seed in (1, 2 ** 31 + 77, 12345):
        s = drivers.Sampler(3, seed)
        kept = [None] * 3
        for j in range(200):
            slot = s.slot(j)
            if slot is not None:
                kept[slot] = j
        assert kept[0] == 0
        assert len(set(kept)) == 3 and all(k > 0 for k in kept[1:])
    # the rest is uniform: each later period is kept about equally often
    hits = np.zeros(20)
    for seed in range(3000):
        s = drivers.Sampler(3, seed)
        kept = [None] * 3
        for j in range(20):
            slot = s.slot(j)
            if slot is not None:
                kept[slot] = j
        hits[kept[1:]] += 1
    assert hits[0] == 0
    assert np.all(np.abs(hits[1:] / 3000 - 2 / 19) < 0.03)


def test_forcing_is_reproducible_by_seed():
    seed = 2 ** 31 + 987654321
    a = common.year_of_forcing(64, seed, 12)
    b = common.year_of_forcing(64, seed, 12)
    c = common.year_of_forcing(64, seed + 1, 12)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert not np.array_equal(a[0], a[1])
    assert a[0].dtype == np.float32 and a[0].shape == (8, 64)
    assert np.array_equal(common.held_fields(64, seed, 2),
                          common.held_fields(64, seed, 2))


def imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for f in files:
        bad = imports(f) & {"jax", "jaxlib", "icebin_tpu"}
        assert not bad, f"{f} imports {bad}"


def test_a_run_that_loaded_jax_is_seen(monkeypatch):
    import icebin_tpu_torch  # noqa: F401  (named as the JAX package, longer)
    import run as bench
    assert "icebin_tpu_torch" in sys.modules
    assert "icebin_tpu_torch" not in bench.foreign_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "icebin_tpu.ops", object())
    assert {"jax", "icebin_tpu"} <= set(bench.foreign_modules())


def test_the_reference_imports_nothing_of_the_program():
    for f in sorted((BENCH / "reference").rglob("*.py")):
        assert "icebin_tpu_torch" not in imports(f), f
