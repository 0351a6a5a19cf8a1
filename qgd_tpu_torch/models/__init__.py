"""Problem builders (numpy copies of ``qgd_tpu.models``)."""

from .builders import (
    lowering_operator_subsystem,
    lowering_operators_system,
    basis_state,
    create_initial_conditions,
    guard_projector,
    create_gate,
    rotation_matrix,
    multi_qudit_hamiltonian_dispersive,
    control_ops,
    DispersiveProblem,
    cnot3_problem,
    cnot3_target,
    cnot2_problem,
)

__all__ = [
    "lowering_operator_subsystem",
    "lowering_operators_system",
    "basis_state",
    "create_initial_conditions",
    "guard_projector",
    "create_gate",
    "rotation_matrix",
    "multi_qudit_hamiltonian_dispersive",
    "control_ops",
    "DispersiveProblem",
    "cnot3_problem",
    "cnot3_target",
    "cnot2_problem",
]
