"""``stage_kernels_roofline`` (%): the three stage kernels' share of their
roofline over the traced calls.

The work is what the Hermite steps need of the stage build at the cell's
shapes, whatever kernels do it: per counted time step and control vector
the forward's implicit-stage matrix ``LHS(t_{n+1})`` (the identity
recursion: ``m (m-1) / 2`` products of n x n matrices, the stack of m
generator matrices in and one matrix out), its explicit half applied to
the state (``m (m+1) / 2`` products of an n x n matrix and the n x b
state, the stack and the state in, the state out), and the backward's pair
``(R(t_n), L(t_n))`` (the identity recursion once, the stack in and two
matrices out). A re-forward is not needed work. FLOPs count the products
(2 per multiply-add); bytes count each input once and each output once in
float32. Each part's bound is the larger of its FLOPs over the TF32 peak
(a float32-accurate product on the tensor cores takes 3 TF32 passes, so
no kernel reads over it) and its bytes over HBM's rate. The share is the
summed bound over the summed device time of the kernels whose names hold
``lhs_``, ``stage_pair`` or ``rhs_`` (at m >= 3 the pair runs as an
``lhs_`` kernel); with none of them traced it reads nothing.
"""

from qgdbench import peaks
from qgdbench.profiling import stage_seconds

F32 = 4


def lhs_work(n: int, m: int):
    """``(flops, bytes)`` of one implicit-stage matrix."""
    return m * (m - 1) // 2 * 2 * n ** 3, F32 * (m + 1) * n * n


def rhs_work(n: int, m: int, b: int):
    """``(flops, bytes)`` of one explicit half applied to an n x b state."""
    return m * (m + 1) // 2 * 2 * n * n * b, F32 * (m * n * n + 2 * n * b)


def pair_work(n: int, m: int):
    """``(flops, bytes)`` of one pair ``(R, L)``."""
    return m * (m - 1) // 2 * 2 * n ** 3, F32 * (m + 2) * n * n


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / peaks.TF32_FLOPS, nbytes / peaks.HBM_BYTES_PER_S)


def step_bound_s(n: int, m: int, b: int) -> float:
    """The least time of one counted time step's stage build for one
    control vector (forward and backward)."""
    return (bound_s(*lhs_work(n, m)) + bound_s(*rhs_work(n, m, b))
            + bound_s(*pair_work(n, m)))


def read(ctx):
    t = stage_seconds(ctx["device_ops"])
    if t <= 0:
        return None
    bound = (ctx["calls"] * ctx["nsteps"] * ctx["batch"]
             * step_bound_s(ctx["n"], ctx["m"], ctx["b"]))
    return 100.0 * bound / t
