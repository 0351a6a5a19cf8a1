"""Level-sharded (tensor-parallel) propagation for systems too large for one
device (counterpart of ``qgd_tpu.parallel.state_sharded``), on
``torch.distributed``.

The N levels are row-sharded over the ``tp`` ranks of a process group:

* each rank holds the ``(N/tp, N)`` row blocks of the drift and control
  operators (``K = Re H``, ``S = Im H``) and its rows of the state,
  ``w_loc = [u_loc; v_loc]`` of shape ``(2N/tp, B)``;
* applying the generator is an ``all_gather`` of the state followed by the
  local row-block products; each derivative level gathers its new state
  once;
* the implicit stage is GMRES (``ops.gmres``) whose inner products and
  norms are ``all_reduce``d over the group; the small Hessenberg
  least-squares solve is then the same on every rank.

Where this differs from the JAX package's version: each gate column keeps
its own Krylov space, as the single-device GMRES does (JAX's sharded GMRES
treats the whole ``(2N, B)`` block as one vector), so the history matches
the single-device GMRES forward to roundoff whether or not GMRES has
converged; the problem's preconditioner applies (``"diagonal"`` acts on
each rank's own rows, ``"lu"`` gathers the vector and solves it whole on
every rank), where JAX's runs unpreconditioned; and each level is gathered
once, where JAX gathers a level again for every later level that uses it.

The backend follows the problem's device: NCCL for the card, gloo for the
CPU. A group of the other backend is refused, not switched.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..controls import as_control_tuple
from ..forward import _scenario_pcof, _working_tables
from ..ops.gmres import gmres_solve
from ..ops.hermite import build_lhs, build_rhs, taylor_expand
from ..ops.preconditioners import (block2_apply, diagonal_coefficients,
                                   no_control_lhs)


def _backend_for(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def make_tp_mesh(n_tp: int, *, device="cuda", init_method: str | None = None,
                 rank: int | None = None):
    """The process group :func:`tp_forward_history` shards over: the first
    ``n_tp`` ranks of ``torch.distributed``'s default group (the default
    group itself when it has ``n_tp`` ranks).

    If ``torch.distributed`` is not initialized yet, it is set up here with
    world size ``n_tp``, this process's ``rank`` and ``init_method`` (e.g.
    ``"tcp://localhost:29500"``), backend NCCL for ``device="cuda"`` and
    gloo for ``device="cpu"``. An initialized default group of the other
    backend raises."""
    init_default_group(device, init_method, n_tp, rank)
    _check_backend(None, device)
    world = dist.get_world_size()
    if n_tp > world:
        raise ValueError(f"n_tp={n_tp} exceeds the world size {world}")
    if n_tp == world:
        return dist.group.WORLD
    return dist.new_group(list(range(n_tp)))


def init_default_group(device, init_method: str | None,
                       world_size: int | None, rank: int | None,
                       backend: str | None = None) -> None:
    """Set up ``torch.distributed``'s default group unless it is up: the
    ``backend`` given, else NCCL for ``device="cuda"`` and gloo for
    ``device="cpu"``; ``init_method`` (``"tcp://host:port"``, or
    ``"env://"`` with ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and
    ``RANK`` in the environment), the world size and this process's
    rank."""
    if dist.is_initialized():
        return
    if init_method is None or (rank is None and init_method != "env://"):
        raise ValueError("torch.distributed is not initialized: pass "
                         "init_method and rank to set it up")
    # -1: read from the environment (env://)
    dist.init_process_group(
        backend or _backend_for(device), init_method=init_method,
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank)


def _check_backend(group, device):
    want = _backend_for(device)
    got = dist.get_backend(group)
    if got != want:
        raise ValueError(f"the process group's backend is {got!r}; a problem "
                         f"on {torch.device(device).type} needs {want!r}")


class _Shard:
    """This rank's rows and the collectives over the group."""

    def __init__(self, group, N: int):
        self.group = group
        self.tp = dist.get_world_size(group)
        if N % self.tp:
            raise ValueError(f"N={N} levels do not split over {self.tp} "
                             f"ranks")
        self.N, self.Nl = N, N // self.tp
        r = dist.get_rank(group)
        self.rows = slice(r * self.Nl, (r + 1) * self.Nl)

    def gather(self, x):
        """Local rows ``(..., 2Nl, b)`` -> the full ``(..., 2N, b)``."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.tp)]
        dist.all_gather(parts, x, group=self.group)
        g = torch.stack(parts, dim=-3)                     # (..., tp, 2Nl, b)
        g = g.unflatten(-2, (2, self.Nl)).transpose(-4, -3)   # (.., 2, tp, ..)
        return g.flatten(-4, -2)

    def local(self, x):
        """The full ``(..., 2N, b)`` -> this rank's rows."""
        r = self.rows
        return torch.cat([x[..., r, :],
                          x[..., self.N + r.start:self.N + r.stop, :]],
                         dim=-2)

    def allreduce(self, t):
        t = t.contiguous()
        dist.all_reduce(t, group=self.group)
        return t


def _local_stack(wprob, shard, p, q, m: int):
    """This rank's rows ``(S, m, 2Nl, 2N)`` of the generator stack for the
    tables ``p, q (S, m, N_ops)``."""
    r = shard.rows
    Sd, Kd = wprob.system_asym[r], wprob.system_sym[r]
    if wprob.N_operators > 0:
        S = torch.einsum("...kj,jab->...kab", q, wprob.asym_operators[:, r])
        K = torch.einsum("...kj,jab->...kab", p, wprob.sym_operators[:, r])
    else:
        S = torch.zeros(p.shape[:-1] + Sd.shape, dtype=Sd.dtype,
                        device=Sd.device)
        K = torch.zeros_like(S)
    S[..., 0, :, :] += Sd
    K[..., 0, :, :] += Kd
    return torch.cat([torch.cat([S, K], dim=-1),
                      torch.cat([-K, S], dim=-1)], dim=-2)


def _derivs(shard, A_loc, w_loc, m: int):
    """The scaled-derivative recursion on this rank's rows ``(S, m+1, 2Nl,
    b)``: each level but the last is gathered once, for the levels after
    it."""
    Ws, full = [w_loc], [shard.gather(w_loc)]
    for j in range(m):
        acc = A_loc[:, j] @ full[0]
        for i in range(1, j + 1):
            acc = acc + A_loc[:, j - i] @ full[i]
        Ws.append(acc / (j + 1))
        if j + 1 < m:
            full.append(shard.gather(Ws[-1]))
    return torch.stack(Ws, dim=-3)


def _local_preconditioner(prob, shard, dt64: float, order: int):
    """The forward apply of ``prob.preconditioner_type`` on this rank's
    rows, or ``None``."""
    kind = prob.preconditioner_type
    if kind == "identity":
        return None
    if kind == "diagonal":
        a, b, det = diagonal_coefficients(prob, dt64, order)
        r = shard.rows
        return block2_apply((a / det)[r], (-b / det)[r])
    LU, piv = torch.linalg.lu_factor(no_control_lhs(prob, dt64, order))

    def apply(v):
        full = torch.linalg.lu_solve(LU, piv, shard.gather(v).to(LU.dtype))
        return shard.local(full).to(v.dtype)

    return apply


@torch.no_grad()
def tp_forward_history(prob, controls, pcof, group=None, order: int = 4,
                       gmres_iters: int | None = None):
    """Forward evolution with the levels sharded over the ranks of
    ``group`` (the default group if ``None``; see :func:`make_tp_mesh`),
    every stage solved by GMRES (``gmres_iters`` Arnoldi steps, default
    ``prob.gmres_iters``) from the Taylor guess with the problem's
    preconditioner, in the problem's dtype. Every rank calls it with the
    same arguments. Returns the full history ``(T+1, 2N, B)`` (``(S, T+1,
    2N, B)`` for ``pcof (S, N_params)``) on every rank, comparable to
    :func:`~qgd_tpu_torch.eval_forward` with ``solver="gmres"``."""
    controls = as_control_tuple(controls)
    group = dist.group.WORLD if group is None else group
    _check_backend(group, prob.device)
    shard = _Shard(group, prob.N_tot_levels)
    iters = prob.gmres_iters if gmres_iters is None else int(gmres_iters)
    m = order // 2
    pcof, single = _scenario_pcof(prob, pcof)
    wprob, dt64, dt, P, Q = _working_tables(prob, controls, pcof, m)
    precond = _local_preconditioner(prob, shard, dt64, order)

    w = shard.local(wprob.w0).expand(P.shape[0], -1, -1)
    states = [w]
    A_n = _local_stack(wprob, shard, P[:, 0], Q[:, 0], m)
    for k in range(prob.nsteps):
        A_np1 = _local_stack(wprob, shard, P[:, k + 1], Q[:, k + 1], m)
        Ws = _derivs(shard, A_n, w, m)
        w = gmres_solve(
            lambda v: build_lhs(_derivs(shard, A_np1, v, m), dt, m),
            build_rhs(Ws, dt, m), taylor_expand(Ws, dt, m), iters=iters,
            precond=precond, reduce=shard.allreduce)
        states.append(w)
        A_n = A_np1
    hist = shard.gather(torch.stack(states, dim=1))
    return hist[0] if single else hist
