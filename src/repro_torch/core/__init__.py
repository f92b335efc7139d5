"""The paper's joint probabilistic client selection and power allocation
(Marnissi et al., 2024) on torch tensors, as ``repro.core``."""
from repro_torch.core.alternating import (
    FleetElements,
    JointSolution,
    WarmStart,
    fused_fixed_point,
    fused_fixed_point_flat,
    problem_elements,
    select_best_bits,
    solve_joint,
    solve_joint_fused,
    solve_joint_trace,
)
from repro_torch.core.batch import (
    BatchSolution,
    ProblemBatch,
    batch_elements,
    pad_batch,
    solve_joint_batch,
    stack_problems,
)
from repro_torch.core.multicell import (
    CoupledDuals,
    MultiCellProblem,
    MultiCellSolution,
    cell_interference,
    grid_coupling,
    make_multicell,
    solve_coupled,
    solve_coupled_loop,
)
from repro_torch.core.optimal import solve_joint_optimal
from repro_torch.core.power import (PowerSolution, analytic_power,
                                    dinkelbach_power, energy_bound_ok)
from repro_torch.core.problem import (GRAD_SIZE_BITS_FP32, WirelessFLProblem,
                                      sample_problem)
from repro_torch.core.schedulers import (
    SCHEDULERS,
    DeterministicScheduler,
    EquallyWeightedScheduler,
    GreedyChannelScheduler,
    LyapunovScheduler,
    ParticipationDraw,
    ProbabilisticScheduler,
    SchedulerState,
    UniformScheduler,
    make_scheduler,
)
from repro_torch.core.scenarios import (
    SCENARIOS,
    Scenario,
    gauss_markov_fading,
    make_batch,
    make_mixed_batch,
    make_problem,
    slice_round,
)
from repro_torch.core.selection import optimal_selection

__all__ = [
    "FleetElements", "JointSolution", "WarmStart", "fused_fixed_point",
    "fused_fixed_point_flat", "problem_elements", "select_best_bits",
    "solve_joint",
    "solve_joint_fused", "solve_joint_trace", "solve_joint_optimal",
    "PowerSolution", "analytic_power", "dinkelbach_power", "energy_bound_ok",
    "GRAD_SIZE_BITS_FP32", "WirelessFLProblem", "sample_problem",
    "SCHEDULERS", "DeterministicScheduler", "EquallyWeightedScheduler",
    "GreedyChannelScheduler", "LyapunovScheduler",
    "ParticipationDraw", "ProbabilisticScheduler", "SchedulerState",
    "UniformScheduler", "make_scheduler", "optimal_selection",
    "ProblemBatch", "BatchSolution", "stack_problems",
    "solve_joint_batch", "batch_elements", "pad_batch",
    "Scenario", "SCENARIOS", "make_problem", "make_batch", "make_mixed_batch",
    "gauss_markov_fading", "slice_round",
    "MultiCellProblem", "MultiCellSolution", "CoupledDuals",
    "make_multicell", "grid_coupling", "cell_interference",
    "solve_coupled", "solve_coupled_loop",
]
