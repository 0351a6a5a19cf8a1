"""The control-table cotangent of the segmented route's backward
(``segmented._table_cot``, contracted through the operator basis) against
an autograd oracle: the VJP of ``scaled_derivatives(assemble_generator_
stack(p, q), w)`` with respect to the tables, on the CNOT3 operators.

Tolerances: float64 relative <= 1e-12 (two orders of the same sums,
~1e-16 here); float32 <= 1e-5 (roundoff of the f32 products, ~1e-7);
forward-mode tangents of both, float64, <= 1e-12. A wrong term or sign
shows at 1e-2 or more.
"""

import dataclasses

import pytest
import torch
import torch.autograd.forward_ad as fwAD

import qgd_tpu_torch as qt
from qgd_tpu_torch.ops.hermite import (assemble_generator_stack,
                                       scaled_derivatives)
from qgd_tpu_torch.problem import working_problem
from qgd_tpu_torch.segmented import _no_graph, _table_cot

torch.set_num_threads(1)

S, T = 3, 2                        # scenarios, time points


def _oracle(wprob, m, p, q, w, cot):
    """The VJP by autograd through the materialised generator stack
    (``_no_graph`` keeps the forward-mode tangents ``detach`` drops)."""
    with torch.enable_grad():
        p = _no_graph(p).requires_grad_(True)
        q = _no_graph(q).requires_grad_(True)
        Ws = scaled_derivatives(assemble_generator_stack(wprob, p, q, m), w,
                                m)
        return torch.autograd.grad(Ws, (p, q), cot)


def _case(dtype, m, seed=0):
    """The working CNOT3 problem and random ``(p, q, w, cot)`` in its
    dtype, ``S x T`` points."""
    wprob = working_problem(qt.cnot3_problem(tf=4.4, nsteps=8, dtype=dtype,
                                             device="cpu"))
    g = torch.Generator().manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.float64).to(
            wprob.system_sym.dtype)

    n, B = 2 * wprob.N_tot_levels, wprob.N_initial_conditions
    O = wprob.N_operators
    return (wprob, 0.05 * rand(S, T, m, O), 0.05 * rand(S, T, m, O),
            rand(S, T, n, B), rand(S, T, m + 1, n, B))


def _rel(a, b):
    a, b = torch.cat([x.flatten() for x in a]), torch.cat(
        [x.flatten() for x in b])
    return float(torch.linalg.norm((a - b).double())
                 / torch.linalg.norm(b.double()))


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12),
                                       ("float32", 1e-5)])
@pytest.mark.parametrize("order", [2, 4, 6, 8, 10])
def test_table_cot_matches_autograd(order, dtype, tol):
    m = order // 2
    wprob, p, q, w, cot = _case(dtype, m)
    got = _table_cot(wprob, m, p, q, w, cot)
    want = _oracle(wprob, m, p, q, w, cot)
    assert all(x.shape == p.shape and x.dtype == p.dtype for x in got)
    assert _rel(got, want) <= tol


def test_table_cot_without_operators():
    """A drift-only problem: empty ``(..., m, 0)`` cotangents."""
    m = 2
    wprob, p, q, w, cot = _case("float64", m)
    wprob = dataclasses.replace(
        wprob, sym_operators=wprob.sym_operators[:0],
        asym_operators=wprob.asym_operators[:0])
    cotP, cotQ = _table_cot(wprob, m, p[..., :0], q[..., :0], w, cot)
    assert cotP.shape == cotQ.shape == (S, T, m, 0)
    assert cotP.dtype == cotQ.dtype == torch.float64


def _dual_tangents(fn, primals, tangents):
    """Tangents of ``fn``'s outputs by dual tensors, as
    ``adjoint.eval_hessian`` carries them (the oracle's ``autograd.grad``
    runs inside a dual level, not inside a ``torch.func`` transform)."""
    with fwAD.dual_level():
        out = fn(*(fwAD.make_dual(x, t) for x, t in zip(primals, tangents)))
        return [fwAD.unpack_dual(o).tangent for o in out]


def test_table_cot_forward_mode_matches_autograd():
    """Tangents on every input ``(p, q, w, cot)``."""
    m = 3
    wprob, *primals = _case("float64", m)
    tangents = _case("float64", m, seed=1)[1:]
    _, got = torch.func.jvp(lambda *a: _table_cot(wprob, m, *a),
                            tuple(primals), tuple(tangents))
    want = _dual_tangents(lambda *a: _oracle(wprob, m, *a), primals,
                          tangents)
    assert _rel(got, want) <= 1e-12
    assert _rel(_dual_tangents(lambda *a: _table_cot(wprob, m, *a), primals,
                               tangents), want) <= 1e-12
