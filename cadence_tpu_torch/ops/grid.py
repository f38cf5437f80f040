"""Compiled-shape grid policy — ONE place every device caller sizes
jit-specialization keys from.

Scan length, batch width, lane count, and the resume tensor's batch dim
are all jit specialization keys: every distinct value compiles a fresh
executable. The policy here bounds that set two ways:

* :func:`round_scan_len` rounds any size up to the ``{2^k, 3*2^(k-1)}``
  geometric grid (<= 2 shapes per octave, < 50% padding worst case),
  so a storm of arbitrary-sized batches — or a serving tick's arbitrary
  Δ widths — forces only a logarithmic executable set;
* :func:`staging_depth` sizes a dispatcher's staged-batch queue to the
  work that actually exists, so a one-batch caller (the common serving
  shape) doesn't allocate double-buffer headroom it can never use.

A copy of the reference package's grid: the port pads batches and
scan lengths to the same grid points so its packed tensors equal the
reference packer's byte for byte.
"""

from __future__ import annotations


def round_scan_len(n: int, floor: int = 8) -> int:
    """Round ``n`` up to the {2^k, 3·2^(k-1)} geometric grid.

    Scan length and batch width are jit specialization keys: rounding
    them to this grid bounds how many executables a storm of
    arbitrary-sized batches can force (≤ 2 per octave) at < 50% padding
    worst case (just past a power of two), ~20% expected.
    """
    if n <= floor:
        return floor
    k = (n - 1).bit_length()
    p = 1 << k
    if 3 * (p >> 2) >= n:
        return 3 * (p >> 2)
    return p


def grid_points(lo: int, hi: int, floor: int = 8):
    """Every grid value in [lo, hi] — the full executable set a caller
    sweeping arbitrary sizes through :func:`round_scan_len` can compile
    (the boundedness tests enumerate against this)."""
    out = []
    n = floor
    while n <= hi:
        if n >= lo:
            out.append(n)
        # next grid point: 8, 12, 16, 24, 32, ...
        n = round_scan_len(n + 1, floor)
    return out


def staging_depth(n_batches: int, depth: int = 2) -> int:
    """Staged-batch queue depth for a dispatcher about to receive
    ``n_batches`` submissions: classic double buffering (``depth``)
    capped at the batch count — a single-batch stream (the serving /
    small-rebuild shape) gets a one-slot buffer instead of idle
    headroom sized for a storm."""
    return max(1, min(depth, max(n_batches, 1)))
