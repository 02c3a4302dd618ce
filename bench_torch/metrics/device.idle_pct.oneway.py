"""The device idle share of the window, untraced (harness.common.idle_pct),
in the one-way cells; it moves oneway_steps_per_s."""
from harness.common import idle_pct as read  # noqa: F401
