"""The frozen work count of ICP's nearest-neighbour scan: bytes and f32 operations a scan.

It counts what a brute search needs from the number of pairs of points it compares and the
points of each cloud, and nothing of how the program computes. Each pair takes 9 f32
operations: 3 differences, 3 squares (or a square and two fused multiply-adds, counted as
two each), 2 adds and 1 compare. Bytes are the two clouds read once a scan, 3 float32
coordinates a point. The peaks are those of ``gpu_bench/work.py``.
"""

from __future__ import annotations

OPS_PER_PAIR = 9
BYTES_PER_POINT = 3 * 4


def scan_work(pairs: int, points: int) -> tuple[int, int]:
    """(bytes, operations) of one nearest-neighbour scan over `pairs` pairs of points between
    two clouds of `points` points each."""
    return BYTES_PER_POINT * 2 * points, OPS_PER_PAIR * pairs
