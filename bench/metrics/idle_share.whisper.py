"""idle_share.whisper: the share of the traced stretch in which no
operation ran on the device, in % (`trace.idle_share`)."""

from bench.trace import idle_share as read  # noqa: F401
