"""K4, ``chol_solve`` (``csrc/small_chol.cu``): B damped (P, P) SPD solves
of the window smoother per LM iteration, P = 9 (W + 1).

The least it must move, per batched call: the lower triangle of each A
(an SPD solve reads one triangle), b read once and x written once; the
operations of a Cholesky factorisation and two triangular solves."""

from .peaks import least_seconds


def work(B: int, P: int):
    """(bytes, operations) of one batched call."""
    nbytes = B * (P * (P + 1) // 2 + 2 * P) * 4
    flops = B * (2 * P ** 3 // 3 + 2 * P * P)
    return nbytes, flops


def least(B: int, P: int) -> float:
    return least_seconds(*work(B, P))
