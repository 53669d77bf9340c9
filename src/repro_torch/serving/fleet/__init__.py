"""Cross-process partition fleet: workers, launcher, supervision, RPC
(counterpart of ``repro.serving.fleet``).

``PartitionFleet.launch(P).attach(engine)`` moves a partitioned engine's
per-level scatter-gather work into P worker processes, each with its own
CUDA context and device memory (``device=`` names where they run: the card
by default), while the coordinator keeps the router head and the small
per-level beam merges. Results stay bitwise in-process serving's. The
frames are byte for byte the reference's, so a worker of either package
answers a coordinator of the other.

Robustness lives here too: :class:`FleetSupervisor` respawns dead workers
(UP → SUSPECT → RESTARTING → UP, or FAILED once its budget is spent), the
fleet's ``degraded_policy`` decides whether a partition loss fails queries
or serves survivor-exact partial rankings, and :class:`FaultInjector` is
the deterministic chaos seam the tests drive failures through.
"""

from repro_torch.serving.fleet.launcher import (
    PartitionFleet,
    WorkerHandle,
    launch_workers,
    partition_payload,
)
from repro_torch.serving.fleet.rpc import (
    FaultInjector,
    FaultRule,
    RemoteError,
    WorkerConnection,
)
from repro_torch.serving.fleet.supervisor import (
    STATE_FAILED,
    STATE_RESTARTING,
    STATE_SUSPECT,
    STATE_UP,
    WORKER_STATES,
    FleetSupervisor,
)

__all__ = [
    "FaultInjector",
    "FaultRule",
    "FleetSupervisor",
    "PartitionFleet",
    "RemoteError",
    "STATE_FAILED",
    "STATE_RESTARTING",
    "STATE_SUSPECT",
    "STATE_UP",
    "WORKER_STATES",
    "WorkerConnection",
    "WorkerHandle",
    "launch_workers",
    "partition_payload",
]
