"""K2, ``segment_topk_moments`` (``csrc/segment_moments.cu``): the 13 moment
channels of the k most-populated cells of each member's scan.

The least it must move, per batched call: every point's cell id and the
k kept ids of each member (4 bytes each), the value rows of the points in
the kept cells (``kept_rows`` over the batch), and the (B, k, CH) output;
one add per kept row and channel."""

from .peaks import least_seconds


def work(B: int, P: int, CH: int, k: int, kept_rows: float):
    """(bytes, operations) of one batched call."""
    nbytes = B * (P * 4 + k * 4 + k * CH * 4) + kept_rows * CH * 4
    return nbytes, kept_rows * CH


def least(B: int, P: int, CH: int, k: int, kept_rows: float) -> float:
    return least_seconds(*work(B, P, CH, k, kept_rows))
