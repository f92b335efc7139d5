"""Online fleet control plane on torch: the request-driven serving path.

As ``repro.serve``: the base station re-solves the joint selection/power
problem (Algorithm 2) every round for every cell it serves, and
:class:`FleetControlService` is that online service (an arrival queue
with deadlines, continuous batching, priority lanes, warm-started solves
on drifting channels).  ``load_gen`` makes the seeded Poisson/bursty
traffic and drives the loop; ``faults`` is the seeded chaos harness.
"""
from repro_torch.serve.faults import (
    CHANNEL_KINDS,
    FAULT_KINDS,
    ChaosReport,
    FaultPlan,
    chaos_drive,
    corrupt_problem,
    corrupt_trace,
    count_nonfinite,
    dropout_mask,
)
from repro_torch.serve.fleet_service import (
    CLOSE_DEADLINE,
    CLOSE_FORCED,
    CLOSE_FULL,
    CLOSE_LINGER,
    BatchRecord,
    BucketCostModel,
    CoupledResponse,
    FleetControlService,
    ServiceConfig,
    ServiceStats,
    SolveRequest,
    SolveResponse,
    batch_close_reason,
    quantized_problem_key,
)
from repro_torch.serve.load_gen import (
    Arrival,
    DriveReport,
    bursty_trace,
    drive,
    make_cells,
    measure_capacity,
    poisson_trace,
)

__all__ = [
    "FleetControlService", "ServiceConfig", "ServiceStats",
    "SolveRequest", "SolveResponse", "BatchRecord", "BucketCostModel",
    "CoupledResponse",
    "batch_close_reason", "quantized_problem_key",
    "CLOSE_FULL", "CLOSE_DEADLINE", "CLOSE_LINGER", "CLOSE_FORCED",
    "Arrival", "DriveReport", "make_cells", "poisson_trace",
    "bursty_trace", "drive", "measure_capacity",
    "FaultPlan", "ChaosReport", "FAULT_KINDS", "CHANNEL_KINDS",
    "chaos_drive", "corrupt_problem", "corrupt_trace", "count_nonfinite",
    "dropout_mask",
]
