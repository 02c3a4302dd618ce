"""Test harness config: run the whole suite on a virtual 8-device CPU mesh.

SURVEY.md section 4 "takeaway": the reference has no distributed-test harness;
we do better by forcing 8 virtual CPU devices so every shard_map/pjit path is
exercised without TPU hardware, and enabling x64 so the oracle comparisons are
done in f64.  TPU-hardware runs happen via bench.py / tools/, not pytest.
"""
import os

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips without one "
                   "(run on the card: python -m pytest --noconftest "
                   "tests/test_torch_cuda.py)")
