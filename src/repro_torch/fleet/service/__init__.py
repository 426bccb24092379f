"""Event-driven scheduler service: the fleet's always-on core.

The lockstep ``FleetScheduler.run`` loop re-cast as a service
(server / storage / queue-manager split):

* ``events`` — typed sim-clock events + the deterministic ``EventBus``
  (arrival, completion, drift, node-down/up, heartbeat, tick);
* ``store`` — ``JobStore``/``LedgerStore`` snapshot encoding, the
  atomic ``Journal``, and the deterministic belief re-fit at recovery;
* ``manager`` — worker ``NodeManager``s that claim placements and
  stream completions/heartbeats back as events;
* ``core`` — ``SchedulerService``: reaction loop (one ``step()`` per
  event batch), durable commits, node-failure handling, crash recovery.

Contract: event-driven mode reproduces the lockstep schedule bitwise,
and a killed service resumed from its journal completes the exact
schedule the uninterrupted run would have produced (enforced by
``tests/test_torch_service.py`` / ``tests/test_torch_service_recovery.py``).
"""

from repro_torch.fleet.service.core import (  # noqa: F401
    SchedulerService,
    ServiceKilled,
)
from repro_torch.fleet.service.events import (  # noqa: F401
    EVENT_KINDS,
    SERVICE_SCHEMA_VERSION,
    Event,
    EventBus,
)
from repro_torch.fleet.service.manager import NodeManager  # noqa: F401
from repro_torch.fleet.service.store import (  # noqa: F401
    JobStore,
    Journal,
    JournalTorn,
    LedgerStore,
)
