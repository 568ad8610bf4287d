"""device_idle_share: see _idle.py."""

from portbench.metrics._idle import idle_share as read  # noqa: F401
