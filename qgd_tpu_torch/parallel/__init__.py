"""Multi-device propagation on ``torch.distributed`` (counterpart of
``qgd_tpu.parallel``). Ported so far: the level-sharded (tensor-parallel)
GMRES forward of ``state_sharded``; the scenario and gate-column sharding
of ``qgd_tpu.parallel.sharded`` is not ported yet."""

from .state_sharded import make_tp_mesh, tp_forward_history

__all__ = ["make_tp_mesh", "tp_forward_history"]
