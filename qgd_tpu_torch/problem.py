"""Problem container: the PyTorch counterpart of ``qgd_tpu.problem``.

A frozen dataclass of tensors on one device, the card unless the caller
passes ``device="cpu"``. Only the fields the ported objective + gradient
path reads are carried: the split drift and control operators, the
initial conditions, the guard projector, ``tf`` and the static solver
settings (``solver`` ``"lu"``, ``"schulz"`` or ``"gmres"``,
``schulz_iters``, ``schulz_warm_budget``, the GMRES budget, tolerances
and preconditioner, ``dtype``, ``hoist_batch_hint``).

State representation is the real-stacked ``w = [u; v]`` of the reference
(``A = [[S, K], [-K, S]]`` with ``K = Re(H)``, ``S = Im(H)``); see
``qgd_tpu/problem.py`` for the full field documentation.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class SchrodingerProblem:
    """Definition of a gate-design problem (tensors on ``device``).

    ``system_sym``/``system_asym`` (N, N), ``sym_operators``/
    ``asym_operators`` (N_ops, N, N), ``u0``/``v0`` (N, N_ic),
    ``guard_subspace_projector`` (2N, 2N): float64 unless cast by
    :func:`working_problem`. ``tf`` is a Python float, so every time-grid
    quantity is formed in float64 on the host exactly as the JAX package
    forms it.
    """

    system_sym: torch.Tensor
    system_asym: torch.Tensor
    sym_operators: torch.Tensor
    asym_operators: torch.Tensor
    u0: torch.Tensor
    v0: torch.Tensor
    guard_subspace_projector: torch.Tensor
    tf: float
    nsteps: int
    N_ess_levels: int
    solver: str = "lu"
    # Newton-Schulz TOTAL iteration budget from the universal init.
    schulz_iters: int = 56
    # Warm-start Newton-Schulz budget per stage (-1 = derived from
    # schulz_iters, 0 = solve every stage by refinement sweeps
    # preconditioned with the one drift-only inverse).
    schulz_warm_budget: int = -1
    # solver="gmres": the fixed Arnoldi budget per stage solve, the
    # preconditioner ("identity", "lu" or "diagonal", ops/preconditioners)
    # and the requested tolerances, which the fixed-budget solver does not
    # iterate to: diagnostics.stage_residuals checks them and warns.
    gmres_abstol: float = 1e-10
    gmres_reltol: float = 1e-10
    gmres_iters: int = 20
    preconditioner_type: str = "identity"
    # Propagation dtype: "float64" or "float32" (objectives reduce in f64).
    dtype: str = "float64"
    # How many scenario copies of the hoisted per-step stage tensors coexist
    # (stage matrices depend on pcof, so a scenario batch multiplies them).
    # Read by the plain route's hoisting memory cap
    # (forward._use_precomputed_stages); callers batching S scenarios set
    # it to S, as optimize_gate_multistart does.
    hoist_batch_hint: int = 1

    @property
    def work_dtype(self) -> torch.dtype:
        return torch.float32 if self.dtype == "float32" else torch.float64

    @property
    def device(self) -> torch.device:
        return self.system_sym.device

    @property
    def N_tot_levels(self) -> int:
        return self.system_sym.shape[-1]

    @property
    def real_system_size(self) -> int:
        return 2 * self.N_tot_levels

    @property
    def N_operators(self) -> int:
        return self.sym_operators.shape[0]

    @property
    def N_initial_conditions(self) -> int:
        return self.u0.shape[-1]

    @property
    def w0(self) -> torch.Tensor:
        """Real-stacked initial states, shape (2N, N_ic)."""
        return torch.cat([self.u0, self.v0], dim=0)

    def __repr__(self) -> str:
        """Sizes, grid and solver settings (the JAX package's summary)."""
        N = self.N_tot_levels
        guard_rank = int(torch.count_nonzero(torch.diagonal(
            self.guard_subspace_projector))) // 2
        dt = self.tf / self.nsteps
        solver = f"  solver = {self.solver!r}, dtype = {self.dtype!r}"
        if self.solver == "schulz":
            solver += f", schulz_iters = {self.schulz_iters}"
        if self.solver == "gmres":
            solver += (f", gmres_iters = {self.gmres_iters}, "
                       f"preconditioner = {self.preconditioner_type!r}")
        return "\n".join([
            "SchrodingerProblem:",
            f"  levels: {N} total, {self.N_ess_levels} essential, "
            f"{guard_rank} guarded (real system size {2 * N})",
            f"  control operators: {self.N_operators}  |  initial "
            f"conditions: {self.N_initial_conditions}",
            f"  tf = {self.tf:g}, nsteps = {self.nsteps}, dt = {dt:g}",
            solver,
            f"  device = {self.device}"])


SOLVERS = ("lu", "schulz", "gmres")
PRECONDITIONERS = ("identity", "lu", "diagonal")

_ARRAY_FIELDS = ("system_sym", "system_asym", "sym_operators",
                 "asym_operators", "u0", "v0", "guard_subspace_projector")


def _check_problem(system_sym, system_asym, sym_ops, asym_ops, u0, v0,
                   guard, N_ess_levels):
    """Input validation (numpy), as ``qgd_tpu.problem._check_problem``."""
    N = system_sym.shape[0]
    if system_sym.shape != (N, N):
        raise ValueError("Real part of system Hamiltonian is not square.")
    if system_asym.shape != (N, N):
        raise ValueError(
            f"Size {system_asym.shape} of imaginary part of Hamiltonian does "
            f"not match size {(N, N)} of real part.")
    if not np.allclose(system_sym, system_sym.T, atol=0.0):
        raise ValueError("Real part of system Hamiltonian is not symmetric.")
    if not np.allclose(system_asym, -system_asym.T, atol=0.0):
        raise ValueError(
            "Imaginary part of system Hamiltonian is not anti-symmetric.")
    if sym_ops.shape[0] != asym_ops.shape[0]:
        raise ValueError(
            f"Number of symmetric operators {sym_ops.shape[0]} does not match "
            f"number of anti-symmetric operators {asym_ops.shape[0]}.")
    for i, op in enumerate(sym_ops):
        if op.shape != (N, N):
            raise ValueError(f"Symmetric operator {i} has wrong shape.")
        if not np.allclose(op, op.T, atol=0.0):
            raise ValueError(f"Symmetric operator {i} is not symmetric.")
    for i, op in enumerate(asym_ops):
        if op.shape != (N, N):
            raise ValueError(f"Anti-symmetric operator {i} has wrong shape.")
        if not np.allclose(op, -op.T, atol=0.0):
            raise ValueError(
                f"Anti-symmetric operator {i} is not anti-symmetric.")
    if u0.shape != v0.shape:
        raise ValueError(
            f"Size {u0.shape} of the real part of the initial condition does "
            f"not match size {v0.shape} of the imaginary part.")
    if u0.shape[0] != N:
        raise ValueError(
            f"Number of levels {u0.shape[0]} in initial condition is "
            f"inconsistent with system Hamiltonian size {N}.")
    if guard.shape != (2 * N, 2 * N):
        raise ValueError(
            f"Guard subspace projector size {guard.shape} should be twice the "
            f"size {(N, N)} of the complex-valued system.")
    if N_ess_levels > N:
        raise ValueError(
            f"Number of essential levels {N_ess_levels} cannot be greater "
            f"than the total number of levels {N}.")


def schrodinger_problem(system_sym, system_asym, sym_operators,
                        asym_operators, u0, v0, tf: float, nsteps: int,
                        N_ess_levels: int, guard_subspace_projector=None, *,
                        solver: str = "lu", schulz_iters: int = 56,
                        schulz_warm_budget: int = -1,
                        gmres_abstol: float = 1e-10,
                        gmres_reltol: float = 1e-10, gmres_iters: int = 20,
                        preconditioner_type: str = "identity",
                        dtype: str = "float64",
                        device="cuda") -> SchrodingerProblem:
    """Build a validated :class:`SchrodingerProblem` from real split
    operators (numpy or nested lists). ``sym_operators``/``asym_operators``
    may be a list of (N, N) arrays or a stacked (N_ops, N, N) array.

    The problem lives on the card by default; a CPU run passes
    ``device="cpu"``. Without a GPU the default raises."""
    system_sym = np.asarray(system_sym, dtype=np.float64)
    system_asym = np.asarray(system_asym, dtype=np.float64)
    N = system_sym.shape[0]

    def _stack(ops):
        ops = np.asarray(ops, dtype=np.float64)
        if ops.size == 0:
            return np.zeros((0, N, N), dtype=np.float64)
        if ops.ndim == 2:
            ops = ops[None]
        return ops

    sym_operators = _stack(sym_operators)
    asym_operators = _stack(asym_operators)
    u0 = np.asarray(u0, dtype=np.float64)
    v0 = np.asarray(v0, dtype=np.float64)
    if u0.ndim == 1:
        u0 = u0[:, None]
        v0 = v0[:, None]
    if guard_subspace_projector is None:
        guard_subspace_projector = np.zeros((2 * N, 2 * N), dtype=np.float64)
    guard_subspace_projector = np.asarray(guard_subspace_projector,
                                          dtype=np.float64)
    _check_problem(system_sym, system_asym, sym_operators, asym_operators,
                   u0, v0, guard_subspace_projector, N_ess_levels)
    if dtype not in ("float64", "float32"):
        raise ValueError(f"dtype must be 'float64' or 'float32', got {dtype!r}")
    if solver not in SOLVERS:
        raise ValueError(f"solver={solver!r}: expected one of {SOLVERS}")
    if preconditioner_type not in PRECONDITIONERS:
        raise ValueError(f"preconditioner_type={preconditioner_type!r}: "
                         f"expected one of {PRECONDITIONERS}")

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but no CUDA device is available; pass "
            "device='cpu' to build the problem on the CPU")
    t = lambda a: torch.as_tensor(a, dtype=torch.float64).to(device)
    return SchrodingerProblem(
        system_sym=t(system_sym),
        system_asym=t(system_asym),
        sym_operators=t(sym_operators),
        asym_operators=t(asym_operators),
        u0=t(u0),
        v0=t(v0),
        guard_subspace_projector=t(guard_subspace_projector),
        tf=float(tf),
        nsteps=int(nsteps),
        N_ess_levels=int(N_ess_levels),
        solver=solver,
        schulz_iters=int(schulz_iters),
        schulz_warm_budget=int(schulz_warm_budget),
        gmres_abstol=float(gmres_abstol),
        gmres_reltol=float(gmres_reltol),
        gmres_iters=int(gmres_iters),
        preconditioner_type=preconditioner_type,
        dtype=dtype,
    )


def schrodinger_problem_complex(system_hamiltonian, sym_operators,
                                asym_operators, U0, tf: float, nsteps: int,
                                N_ess_levels: int,
                                guard_subspace_projector=None,
                                **kwargs) -> SchrodingerProblem:
    """Build from a complex Hermitian Hamiltonian and complex initial
    states, splitting real and imaginary parts."""
    H = np.asarray(system_hamiltonian, dtype=np.complex128)
    if not np.allclose(H, H.conj().T):
        raise ValueError("System Hamiltonian is not Hermitian.")
    U0 = np.asarray(U0, dtype=np.complex128)
    return schrodinger_problem(
        np.real(H), np.imag(H), sym_operators, asym_operators,
        np.real(U0), np.imag(U0), tf, nsteps, N_ess_levels,
        guard_subspace_projector, **kwargs)


def problem_from_arrays(arrays: dict, *, nsteps: int, N_ess_levels: int,
                        device="cuda", **settings) -> SchrodingerProblem:
    """Carry a problem across from its array fields, given as numpy:
    ``system_sym``, ``system_asym``, ``sym_operators``, ``asym_operators``,
    ``u0``, ``v0``, ``guard_subspace_projector`` and ``tf``, plus the static
    fields as keywords (``settings``: the solver settings and ``dtype`` that
    :func:`schrodinger_problem` takes). Returns the port's problem on
    ``device`` (the card by default, as :func:`schrodinger_problem`)."""
    missing = [k for k in _ARRAY_FIELDS + ("tf",) if k not in arrays]
    if missing:
        raise KeyError(f"problem_from_arrays: missing fields {missing}")
    a = {k: np.asarray(arrays[k], dtype=np.float64) for k in _ARRAY_FIELDS}
    return schrodinger_problem(
        a["system_sym"], a["system_asym"], a["sym_operators"],
        a["asym_operators"], a["u0"], a["v0"], float(np.asarray(arrays["tf"])),
        nsteps, N_ess_levels, a["guard_subspace_projector"], device=device,
        **settings)


def working_problem(prob: SchrodingerProblem) -> SchrodingerProblem:
    """Cast the propagation tensors to the working dtype (no-op for f64).
    The guard projector and ``tf`` stay f64: objectives reduce in f64."""
    if prob.dtype != "float32":
        return prob
    c = lambda x: x.to(torch.float32)
    return dataclasses.replace(
        prob,
        system_sym=c(prob.system_sym),
        system_asym=c(prob.system_asym),
        sym_operators=c(prob.sym_operators),
        asym_operators=c(prob.asym_operators),
        u0=c(prob.u0),
        v0=c(prob.v0),
    )


def vector_problem(prob: SchrodingerProblem,
                   ic_index: int) -> SchrodingerProblem:
    """The problem with the single initial-condition column ``ic_index``."""
    return dataclasses.replace(
        prob,
        u0=prob.u0[:, ic_index:ic_index + 1],
        v0=prob.v0[:, ic_index:ic_index + 1],
    )
