"""Multi-device evaluation on ``torch.distributed`` (counterpart of
``qgd_tpu.parallel``): the scenario and gate-column sharding of
``sharded`` (a ``(scenario, ic)`` grid of ranks; only the objective's
column sums and the gradient are reduced, and the scenarios' results
gathered) and the level-sharded (tensor-parallel) GMRES forward of
``state_sharded``."""

from .sharded import (
    initialize_distributed,
    make_mesh,
    sharded_objective_and_grad,
    batched_objective_and_grad,
    multichip_train_step,
)
from .state_sharded import make_tp_mesh, tp_forward_history

__all__ = [
    "initialize_distributed",
    "make_mesh",
    "sharded_objective_and_grad",
    "batched_objective_and_grad",
    "multichip_train_step",
    "make_tp_mesh",
    "tp_forward_history",
]
