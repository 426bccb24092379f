"""The one sanctioned ``print``: diagnostics that also land in the trace.

Library code must not call ``print`` directly (repro-lint's
``no-bare-print`` rule enforces this); it calls :func:`log` instead.
The message still reaches stdout — these are user-facing diagnostics,
not debug spew — but it is *also* recorded as an instant event when a
tracer is installed, so a recorded run carries its own console story.
"""

from __future__ import annotations

from . import trace


def log(message: str, *, level: str = "info", flush: bool = False) -> None:
    """Emit a diagnostic line to stdout and to the active tracer."""
    tracer = trace.current()
    if tracer.enabled:
        tracer.event("log", cat="log", level=level, message=str(message))
    print(message, flush=flush)  # repro: allow(no-bare-print)
