"""Device us a step in the f64 reductions (ledger sums, repair), by name in
the profiled segment, in the cells that regenerate; it moves
steps_per_s."""
from harness.common import reduce_us_per_step as read  # noqa: F401
