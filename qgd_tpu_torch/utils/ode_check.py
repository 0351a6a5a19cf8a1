"""External ground-truth cross-checks (counterpart of
``qgd_tpu.utils.ode_check``; the role of the reference's OrdinaryDiffEq
and QuTiP extensions): the same Schrodinger problem integrated by scipy's
adaptive ODE solvers, and by QuTiP where it is installed, to hold the
Hermite propagator against.
"""

from __future__ import annotations

import numpy as np
import torch


def _np(x):
    return torch.as_tensor(x).detach().cpu().numpy()


def ode_rhs(prob, controls, pcof):
    """Right-hand side ``dw/dt = A(t) w`` as a numpy callable ``f(t, y)``
    for scipy, with ``A(t)`` from the port's ``control_tables_at`` and
    ``assemble_generator_stack`` in float64 on the problem's device."""
    from ..controls import as_control_tuple, control_tables_at
    from ..ops.hermite import assemble_generator_stack

    controls = as_control_tuple(controls)
    pcof = torch.as_tensor(pcof, dtype=torch.float64).to(prob.device)
    n = prob.real_system_size

    def f(t, y):
        p, q = control_tables_at(controls, pcof, float(t), 1)
        A = assemble_generator_stack(prob, p, q, 1)[0]
        w = torch.as_tensor(y.reshape(n, -1)).to(prob.device)
        return _np(A @ w).reshape(-1)

    return f


def solve_ivp_reference(prob, controls, pcof, *, rtol=1e-10, atol=1e-10,
                        method="DOP853"):
    """Integrate with ``scipy.integrate.solve_ivp`` as an external ground
    truth; returns the final real-stacked state ``(2N, B)`` (numpy)."""
    from scipy.integrate import solve_ivp

    f = ode_rhs(prob, controls, pcof)
    y0 = _np(prob.w0).reshape(-1)
    sol = solve_ivp(f, (0.0, float(prob.tf)), y0, method=method, rtol=rtol,
                    atol=atol)
    if not sol.success:
        raise RuntimeError(f"solve_ivp failed: {sol.message}")
    return sol.y[:, -1].reshape(prob.real_system_size, -1)


def test_agreement(prob, controls, pcof, *, order=4, rtol=1e-8):
    """Max abs deviation of the Hermite propagator's final state from the
    scipy ground truth."""
    from ..forward import eval_forward

    ours = _np(eval_forward(prob, controls, pcof, order)[-1])
    truth = solve_ivp_reference(prob, controls, pcof, rtol=rtol, atol=rtol)
    return float(np.abs(ours - truth).max())


# ---------------------------------------------------------------------------
# QuTiP bridge (optional dependency, imported on use)
# ---------------------------------------------------------------------------

def to_qutip_qobj(prob):
    """The drift Hamiltonian ``H = K + i S`` as a ``qutip.Qobj``. Raises
    ImportError without QuTiP."""
    import qutip

    return qutip.Qobj(_np(prob.system_sym) + 1j * _np(prob.system_asym))


def simulate_prob_no_control(prob, nsteps_out: int = 101):
    """The drift-only Schrodinger equation integrated by ``qutip.sesolve``:
    the complex state history ``(nsteps_out, N, B)``. Raises ImportError
    without QuTiP (the scipy check above needs nothing optional)."""
    import qutip

    H = to_qutip_qobj(prob)
    tlist = np.linspace(0.0, float(prob.tf), nsteps_out)
    u0, v0 = _np(prob.u0), _np(prob.v0)
    out = np.zeros((nsteps_out, prob.N_tot_levels, u0.shape[1]),
                   dtype=np.complex128)
    opts = {"atol": 1e-12, "rtol": 1e-12}
    for b in range(u0.shape[1]):
        psi0 = qutip.Qobj((u0[:, b] + 1j * v0[:, b]).reshape(-1, 1))
        res = qutip.sesolve(H, psi0, tlist, options=opts)
        out[:, :, b] = np.stack([np.asarray(s.full()).ravel()
                                 for s in res.states])
    return out
