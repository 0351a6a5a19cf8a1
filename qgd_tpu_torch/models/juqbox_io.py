"""Juqbox interchange (counterpart of ``qgd_tpu.models.juqbox_io``; the
reference's ``src/ProblemConstructors/juqbox_converter.jl``).

Juqbox.jl is a Julia package, so problems cross over as a dict (or npz)
of its ``objparams`` fields, by the names the reference reads:
``Hconst``, ``Hsym_ops``, ``Hanti_ops``, ``Uinit``, ``T``, ``nsteps``,
``N``, ``wmat_real``.
"""

from __future__ import annotations

import numpy as np

from ..problem import SchrodingerProblem, schrodinger_problem_complex


def convert_juqbox(params: dict, **kwargs) -> SchrodingerProblem:
    """A problem from a dict of Juqbox ``objparams`` fields.

    Required: ``Hconst`` (N, N) complex; ``Hsym_ops``/``Hanti_ops`` lists
    of (N, N); ``Uinit`` (N, N_ess); ``T``; ``nsteps``; ``N`` (the
    essential dimension). Optional: ``wmat_real`` (N, N), the guard weight
    matrix, lifted to ``[[W, 0], [0, W]]`` as the reference lifts it.
    ``Hunc_ops`` must be absent or empty. ``kwargs`` go to
    ``schrodinger_problem`` (``device``, solver settings, ``dtype``); the
    problem is built on the card unless ``device="cpu"``.
    """
    if params.get("Hunc_ops"):
        raise ValueError("Uncoupled operators (Hunc_ops) are not supported "
                         "(the reference asserts the same).")
    H = np.asarray(params["Hconst"], dtype=np.complex128)
    sym_ops = [np.asarray(op, dtype=np.float64)
               for op in params.get("Hsym_ops", [])]
    asym_ops = [np.asarray(op, dtype=np.float64)
                for op in params.get("Hanti_ops", [])]
    U0 = np.asarray(params["Uinit"], dtype=np.complex128)
    W_r = params.get("wmat_real")
    guard = None
    if W_r is not None:
        W_r = np.asarray(W_r, dtype=np.float64)
        Z = np.zeros_like(W_r)
        guard = np.block([[W_r, Z], [Z, W_r]])
    return schrodinger_problem_complex(
        H, sym_ops, asym_ops, U0, float(params["T"]),
        int(params["nsteps"]), int(params["N"]), guard, **kwargs)


def convert_to_juqbox(prob: SchrodingerProblem, Ne, Ng, Cfreq, nCoeff,
                      target_complex) -> dict:
    """A dict of Juqbox ``objparams`` keyword fields for ``prob``, numpy
    throughout, ready for ``Juqbox.objparams`` in a Julia session (e.g.
    through npz)."""
    npy = lambda x: x.detach().cpu().numpy()
    u0, v0 = npy(prob.u0), npy(prob.v0)
    S, K = npy(prob.system_asym), npy(prob.system_sym)
    return dict(
        Ne=list(Ne),
        Ng=list(Ng),
        Tmax=float(prob.tf),
        nsteps=int(prob.nsteps),
        Uinit=u0 - 1j * v0,
        Utarget=np.asarray(target_complex),
        Cfreq=np.asarray(Cfreq),
        Rfreq=np.full(prob.N_operators, np.nan),
        Hconst=np.block([[S, -K], [K, S]]),
        Hsym_ops=list(npy(prob.sym_operators)),
        Hanti_ops=list(npy(prob.asym_operators)),
        nCoeff=int(nCoeff),
    )


def load_juqbox_npz(path: str, **kwargs) -> SchrodingerProblem:
    """Load a Juqbox problem exported as .npz (arrays keyed by the
    ``objparams`` field names; operator lists as ``Hsym_ops_0``,
    ``Hsym_ops_1``, ...)."""
    with np.load(path) as data:
        params = {k: data[k] for k in ("Hconst", "Uinit", "T", "nsteps",
                                       "N")}
        for key in ("Hsym_ops", "Hanti_ops"):
            ops = []
            while f"{key}_{len(ops)}" in data:
                ops.append(data[f"{key}_{len(ops)}"])
            params[key] = ops
        if "wmat_real" in data:
            params["wmat_real"] = data["wmat_real"]
    return convert_juqbox(params, **kwargs)
