"""Device ms a step (the union of the device intervals in the profiled
segment over its steps), in the cells that regenerate; it moves
steps_per_s."""
from harness.common import busy_ms_per_step as read  # noqa: F401
