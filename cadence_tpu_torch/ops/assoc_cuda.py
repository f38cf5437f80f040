"""Segmented affine scan on the GPU: the CUDA kernel and its plain PyTorch
version.

The counterpart of the reference package's ``affine_segscan_pallas``
(``ops/replay_pallas.py``), the direct form of the parallel-in-time
replay (``ops/assoc.py``, ``impl="segscan"``). For every (lane, column)
it composes the per-step int32 affine updates ``x -> mul * x + add`` into
inclusive prefixes along time, mod 2^32::

    (m, a) <- rst ? (mul_t, add_t) : (m * mul_t, a * mul_t + add_t)

with the carry starting at the identity (1, 0); a set ``rst`` begins a
segment and absorbs the carry.

``affine_segscan`` is the kernel wrapper. On CUDA tensors it launches
``csrc/affine_segscan.cu`` (one thread per (lane, column), the time axis
walked in registers) and counts the launch in
``affine_segscan.launches``; on CPU tensors it runs
``affine_segscan_plain``, a loop over time applying the combine.
"""

from __future__ import annotations

from typing import Tuple

import torch

_WRAP = 1 << 32
_HALF = 1 << 31


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values -> int32 with two's-complement wraparound (the low 32
    bits), as the reference's int32 arithmetic wraps."""
    return (((x + _HALF) & (_WRAP - 1)) - _HALF).to(torch.int32)


def affine_combine(a, b):
    """Compose affine updates: ``a`` earlier, ``b`` later, each a
    (mul, add, reset) triple of int32 mul and add and a bool reset. A
    set reset on ``b`` absorbs ``a`` (segment boundary). The products
    run in int64 and wrap to int32, the reference's mod-2^32
    arithmetic."""
    ma, aa, ra = a
    mb, ab, rb = b
    m = torch.where(rb, mb, wrap_int32(ma.long() * mb.long()))
    ad = torch.where(rb, ab, wrap_int32(aa.long() * mb.long() + ab.long()))
    return m, ad, ra | rb


def _check(mul, add, rst) -> Tuple[int, int, int]:
    if mul.dim() != 3 or mul.shape != add.shape:
        raise ValueError(
            f"mul and add must be [T, L, C] of one shape, got "
            f"{tuple(mul.shape)} and {tuple(add.shape)}")
    if mul.dtype != torch.int32 or add.dtype != torch.int32:
        raise ValueError(
            f"mul and add must be int32, got {mul.dtype} and {add.dtype}")
    T, L, C = mul.shape
    if tuple(rst.shape) != (T, L):
        raise ValueError(f"rst must be [T, L] = {(T, L)}, got "
                         f"{tuple(rst.shape)}")
    return T, L, C


def affine_segscan_plain(mul: torch.Tensor, add: torch.Tensor,
                         rst: torch.Tensor):
    """Segmented inclusive prefix composition with plain PyTorch ops.

    ``mul``/``add``: [T, L, C] int32; ``rst``: [T, L], nonzero where the
    step begins a segment. Returns (pm, pa) [T, L, C] int32: the carry
    starts at the identity (1, 0) and takes ``affine_combine`` with each
    step in turn."""
    _check(mul, add, rst)
    pm = torch.empty_like(mul)
    pa = torch.empty_like(add)
    m = torch.ones_like(mul[0])
    a = torch.zeros_like(add[0])
    for t in range(mul.shape[0]):
        r = (rst[t] != 0)[:, None]
        m, a, _ = affine_combine((m, a, r), (mul[t], add[t], r))
        pm[t] = m
        pa[t] = a
    return pm, pa


def affine_segscan(mul: torch.Tensor, add: torch.Tensor, rst: torch.Tensor):
    """Segmented inclusive prefix composition of affine updates.

    ``mul``/``add``: [T, L, C] int32; ``rst``: [T, L] (any integer or bool
    dtype, nonzero = the step begins a segment). Returns new (pm, pa)
    [T, L, C] int32: the state after step t of a segment with base x0 is
    ``pm[t] * x0 + pa[t]``.

    CUDA tensors launch the kernel on the current stream (counted in
    ``affine_segscan.launches``); CPU tensors run
    ``affine_segscan_plain``."""
    devs = {mul.device, add.device, rst.device}
    if devs == {torch.device("cpu")}:
        return affine_segscan_plain(mul, add, rst)
    if len(devs) != 1 or mul.device.type != "cuda":
        raise ValueError(
            f"mul, add and rst on {sorted(map(str, devs))}: the kernel "
            "needs all three on one CUDA device")
    T, L, C = _check(mul, add, rst)
    if not (mul.is_contiguous() and add.is_contiguous()):
        raise ValueError("mul and add must be contiguous")
    # the kernel reads one byte per lane-step; a bool rst goes as it is
    rst = (rst if rst.dtype == torch.bool else rst != 0).contiguous()
    rst = rst.view(torch.uint8)
    pm = torch.empty_like(mul)
    pa = torch.empty_like(add)
    if T == 0 or L * C == 0:
        return pm, pa
    from . import _build

    lib = _build.load("affine_segscan")
    dev = mul.device
    err = lib.cadence_affine_segscan(
        mul.data_ptr(), add.data_ptr(), rst.data_ptr(), pm.data_ptr(),
        pa.data_ptr(), T, L, C, torch.cuda.current_stream(dev).cuda_stream,
        dev.index if dev.index is not None else torch.cuda.current_device(),
    )
    if err:
        raise RuntimeError(
            "affine_segscan kernel launch failed: "
            + lib.cadence_cuda_error_string(err).decode())
    affine_segscan.launches += 1
    return pm, pa


affine_segscan.launches = 0
