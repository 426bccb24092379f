"""The engine-facing part of the heterogeneous node pool.

``AppTerms`` is the bridge into ``core.engine``: a duck-typed
``RooflineTerms`` whose ``step_time(f, cores)`` is the *believed*
execution-time surface of one (app, input) family on the reference node.
It is frozen/hashable, so it doubles as the engine's characterization
cache key: one SVR fit per family, shared by every job in the family.

The node pool, reservations and placement come with the fleet slice
(ROADMAP A5).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.core.node_sim import PROFILES


@dataclasses.dataclass(frozen=True)
class AppTerms:
    """Duck-typed ``RooflineTerms`` for node applications.

    ``step_time(f, cores)`` is the scheduler's believed reference-node
    execution-time surface for one (app, input) workload family;
    ``time_scale`` carries what re-characterization has learned about drift
    (1.0 until telemetry says otherwise).
    """

    app: str
    input_size: float
    time_scale: float = 1.0
    source: str = "profile"

    def step_time(self, f_ghz: float, cores) -> float:
        return (
            PROFILES[self.app].time(float(f_ghz), int(cores), self.input_size)
            * self.time_scale
        )

    @property
    def family(self) -> Tuple[str, float]:
        return (self.app, self.input_size)


def family_key(app: str, input_size: float) -> AppTerms:
    """The canonical engine cache key of one workload family."""
    return AppTerms(app=app, input_size=float(input_size))
