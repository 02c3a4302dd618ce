"""The regrid kernels K1/K2 share of their roofline
(harness.common.spmm_roofline_pct), in the one-way cells; it moves
oneway_steps_per_s."""
from harness.common import spmm_roofline_pct as read  # noqa: F401
