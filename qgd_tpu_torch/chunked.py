"""Host-chunked long-horizon objective and gradient (counterpart of
``qgd_tpu.chunked``): the segmented discrete adjoint driven segment by
segment from the host, chunk by chunk, with one device wait per chunk.

The ``T`` steps are cut into ``S`` segments of ``L`` steps (``n_segments``,
as :func:`~qgd_tpu_torch.segmented.segmented_objective_and_gradient`
cuts them), and the segments into chunks of ``S_c`` (the largest divisor
of ``S`` with ``S_c * L <= max_dispatch_steps``, or ``segments_per_chunk``):

* **forward chunks**: the chunk's control tables from its own time grid,
  then each segment from the incoming state: the segment-start snapshots,
  the chunk-final state and the chunk's trapezoid-weighted guard partial,
  fetched to the host;
* **terminal**: the terminal cost and its gradient, ``lambda_T`` by the
  transposed stage solve, and the index-T term of the gradient;
* **backward chunks** in reverse: each segment re-forwarded from its
  snapshot, its multiplier sweep and merged table cotangents, then the
  chunk's control-table VJP (a chunk's tables and their autograd graph
  are built for that chunk alone, so no whole-horizon table exists); the
  gradient partial is fetched to the host.

The arithmetic per segment is the segmented route's
(``segmented._Work``, ``forward._forward_segment_scan``,
``segmented._segment_backward_step``, ``segmented._terminal_multiplier``);
only the summation of the gradient over time points is cut at chunk
edges, so the values agree with the segmented route at the same segment
count to summation roundoff.

**CUDA graphs.** The segment programs are the segmented route's
(``segmented._SegmentPrograms``, for one control vector): one segment's
forward program and one segment's backward program read static input
buffers (the segment's tables, trapezoid weights, start state, incoming
multiplier), and on a CUDA problem each is captured once as a CUDA graph
at its first run, then replayed for every later segment, under the
segmented route's rules (``solver="gmres"`` runs eagerly, ``"lu"``
factorizes by cuSOLVER) and with its launch counting. The graphs are
kept in a :class:`~qgd_tpu_torch.segmented.SegmentGraphs` that
``optimize_gate`` makes once per run, so every evaluation of a run
replays the same graphs.

``mesh=`` splits the gate columns over the mesh's ``ic`` ranks
(``parallel.sharded.Mesh``): each rank propagates its columns, and the
guard partial, the terminal infidelity's traces and the gradient partial
are all-reduced over the mesh's ``ic_group`` in float64, once per chunk,
outside the graphs.
"""

from __future__ import annotations

import time
import warnings

import torch

from .controls import as_control_tuple, control_tables, control_tables_at
from .objective import ic_sum, target_on_device, terminal_cost_and_grad
from .segmented import (SegmentGraphs, _SegmentPrograms, _table_cot,
                        _terminal_multiplier, choose_segments)


def _chunk_divisor(S: int, L: int, max_dispatch_steps: int) -> int:
    """Largest divisor ``S_c`` of ``S`` with ``S_c * L <= cap`` (so every
    chunk has the same shape), at least 1; ``S`` without a cap."""
    if max_dispatch_steps <= 0:
        return S
    best = 1
    for d in range(1, S + 1):
        if S % d == 0 and d * L <= max_dispatch_steps:
            best = d
    return best


def chunked_objective_and_gradient(prob, controls, pcof, target,
                                   order: int = 4,
                                   cost_type: str = "Infidelity",
                                   ridge_penalty_strength: float = 0.0,
                                   n_segments: int = 0,
                                   max_dispatch_steps: int = 0,
                                   segments_per_chunk: int = 0,
                                   progress=None,
                                   mesh=None, ic_axis: str = "ic", *,
                                   graphs: SegmentGraphs | None = None):
    """Host-chunked equivalent of
    :func:`~qgd_tpu_torch.segmented.segmented_objective_and_gradient` for
    one control vector ``pcof (N_params,)``: ``((j1, guard, ridge),
    grad)``, float64 tensors on the host, each chunk covering ``S_c * L <=
    max_dispatch_steps`` steps (or ``segments_per_chunk`` segments;
    module docstring).

    ``n_segments`` must divide ``nsteps``; 0 takes the segment length near
    sqrt(nsteps) (:func:`~qgd_tpu_torch.segmented.choose_segments`).
    ``progress``: optional callable ``(phase, chunk_index, n_chunks,
    wall_seconds)`` after each chunk's result reached the host (phases
    ``"fwd"``, ``"terminal"``, ``"bwd"``). ``mesh``: a
    ``parallel.sharded.Mesh`` whose ``ic`` ranks split the gate columns
    (``ic_axis`` is the JAX package's name of that axis; the mesh names
    its group itself). ``graphs``: the :class:`SegmentGraphs` to take the
    captured programs from and keep them in.
    """
    controls = as_control_tuple(controls)
    pcof = torch.as_tensor(pcof, dtype=torch.float64).to(prob.device)
    if pcof.dim() != 1:
        raise ValueError(f"pcof must be one control vector (N_params,), "
                         f"got shape {tuple(pcof.shape)}")
    pcof = pcof.detach()
    target_real = target_on_device(prob, target)

    T = prob.nsteps
    S = n_segments if n_segments > 0 else choose_segments(T)
    if T % S:
        raise ValueError(f"n_segments={S} must divide nsteps={T}")
    L = T // S
    if segments_per_chunk > 0:
        if S % segments_per_chunk:
            raise ValueError(
                f"segments_per_chunk={segments_per_chunk} must divide S={S}")
        S_c = segments_per_chunk
    else:
        S_c = _chunk_divisor(S, L, max_dispatch_steps)
        if max_dispatch_steps > 0 and S_c * L > max_dispatch_steps:
            warnings.warn(
                f"segment length L={L} alone exceeds max_dispatch_steps="
                f"{max_dispatch_steps}; dispatches will cover {S_c * L} "
                f"steps. Pass n_segments to shorten segments.")
    C = S // S_c
    m = order // 2
    dt = prob.tf / T

    local, ic_group = prob, None
    if mesh is not None:
        from .parallel.sharded import _local_columns

        local, target_real = _local_columns(prob, target_real, mesh)
        ic_group = mesh.ic_group
    graphs = SegmentGraphs() if graphs is None else graphs
    prog = graphs.programs(_SegmentPrograms, prob, m, L, mesh=mesh,
                           local_prob=local)
    work, wd, dev = prog.work, prog.work.wd, prob.device

    def chunk_grid(k):
        a = k * S_c * L
        return a, torch.arange(a, a + S_c * L + 1, dtype=torch.float64,
                               device=dev) * dt

    def load_segment(Pw, Qw, i, a):
        """The tables and weights of the chunk's segment ``i`` (global
        start ``a + i L``) into the programs' buffers."""
        s = i * L
        prog.P.copy_(Pw[:, s:s + L + 1])
        prog.Q.copy_(Qw[:, s:s + L + 1])
        prog.tau[0].fill_(0.5 if a + s == 0 else 1.0)

    # ---------------- forward chunks ----------------------------------------
    w = work.wprob.w0[None]
    snaps_chunks = []
    guard_sum = 0.0
    for k in range(C):
        t0 = time.perf_counter()
        a, ts_chunk = chunk_grid(k)
        P, Q = control_tables(controls, pcof[None], ts_chunk, m)
        Pw, Qw = P.to(wd), Q.to(wd)
        snaps = torch.empty((S_c,) + tuple(w.shape), dtype=wd, device=dev)
        gp = torch.zeros(1, dtype=torch.float64, device=dev)
        for i in range(S_c):
            load_segment(Pw, Qw, i, a)
            snaps[i] = w
            prog.w.copy_(w)
            w, g = prog.run("fwd")
            gp = gp + g
        w = w.clone()                 # outlives the next replay
        guard_sum += float(ic_sum(gp, ic_group))          # one device wait
        snaps_chunks.append(snaps)
        if progress is not None:
            progress("fwd", k, C, time.perf_counter() - t0)

    # ---------------- terminal ----------------------------------------------
    t0 = time.perf_counter()
    W = prob.guard_subspace_projector
    w_final64 = w.to(torch.float64)
    guard_T = 0.5 * torch.sum(w_final64 * (W @ w_final64))
    j1, dj1 = terminal_cost_and_grad(w_final64, target_real,
                                     prob.N_ess_levels, cost_type, ic_group)
    g_T = dj1 + (dt / prob.tf) * (W @ w_final64)
    with torch.enable_grad():
        pc = pcof.clone().requires_grad_(True)
        p_f, q_f = control_tables_at(controls, pc[None], prob.tf, m)
    p_fw, q_fw = p_f.detach().to(wd), q_f.detach().to(wd)
    lam = _terminal_multiplier(work, p_fw, q_fw, g_T, work.schulz)
    cotP_T, cotQ_T = _table_cot(work.wprob, m, p_fw, q_fw, w,
                                -prog.w_lhs * lam[:, None])
    (grad_T,) = torch.autograd.grad(
        (p_f, q_f), pc, (cotP_T.to(torch.float64), cotQ_T.to(torch.float64)))
    parts = ic_sum(torch.cat([guard_T[None], grad_T]), ic_group)
    host = torch.cat([j1.to(torch.float64), parts]).cpu()  # one device wait
    j1, guard_sum, grad = float(host[0]), guard_sum + float(host[1]), host[2:]
    if progress is not None:
        progress("terminal", 0, 1, time.perf_counter() - t0)

    # ---------------- backward chunks ---------------------------------------
    for k in reversed(range(C)):
        t0 = time.perf_counter()
        a, ts_chunk = chunk_grid(k)
        with torch.enable_grad():
            pc = pcof.clone().requires_grad_(True)
            P, Q = control_tables(controls, pc[None], ts_chunk, m)
            P_left, Q_left = P[:, :-1], Q[:, :-1]
        Pw, Qw = P.detach().to(wd), Q.detach().to(wd)
        cotP = torch.empty_like(Pw[:, :-1])
        cotQ = torch.empty_like(cotP)
        for i in reversed(range(S_c)):
            load_segment(Pw, Qw, i, a)
            prog.w.copy_(snaps_chunks[k][i])
            prog.lam.copy_(lam)
            prog.lam0_scale.fill_(0.0 if a + i * L == 0 else 1.0)
            lam, cP, cQ = prog.run("bwd")
            cotP[:, i * L:(i + 1) * L] = cP
            cotQ[:, i * L:(i + 1) * L] = cQ
        lam = lam.clone()             # outlives the next replay
        (gpart,) = torch.autograd.grad(
            (P_left, Q_left), pc,
            (cotP.to(torch.float64), cotQ.to(torch.float64)))
        grad = grad + ic_sum(gpart, ic_group).cpu()       # one device wait
        snaps_chunks[k] = None
        if progress is not None:
            progress("bwd", C - 1 - k, C, time.perf_counter() - t0)

    n = pcof.shape[0]
    pc_host = pcof.cpu()
    ridge = ridge_penalty_strength * float(pc_host @ pc_host) / n
    grad = grad + 2.0 * ridge_penalty_strength * pc_host / n
    as64 = lambda x: torch.tensor(x, dtype=torch.float64)
    return (as64(j1), as64(guard_sum * dt / prob.tf), as64(ridge)), grad
