"""Coefficient planes in, raster plane out: what the two standalone IDCT
kernels (K5 ``idct_islow_plane``, K6 ``idct_float``) share on the Python side.

Both take int16 SoA coefficient planes ``(..., 64, vb, hb)`` -- plane j holds
natural-order coefficient j of every block -- with one quant table per plane
or one per leading index, and write the ``(..., vb*8, hb*8)`` uint8 raster
plane.  Each is launched once for all planes of a frame
(:func:`launch_planes_kernel`, up to MAX_PLANES descriptors in one call).
The kernels address their input through element strides
(``csrc/block_plane.cuh``), so the block layout ``(..., vb, hb, 8, 8)``
that host entropy and the assembly pass produce goes in as a view
(:func:`blocks_as_soa`), without a transposing copy.
"""

from __future__ import annotations

import ctypes

import torch

MAX_PLANES = 4   # csrc/block_plane.cuh:kMaxPlanes
# jgt_idct_islow_planes / jgt_idct_float_planes: (descriptors, planes, stream).
PLANES_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]


def blocks_as_soa(coefs: torch.Tensor) -> torch.Tensor:
    """(..., vb, hb, 8, 8) blocks -> (..., 64, vb, hb) planes, as a view."""
    *lead, vb, hb, _, _ = coefs.shape
    return coefs.reshape(*lead, vb, hb, 64).movedim(-1, -3)


def soa_as_blocks(coefs_soa: torch.Tensor) -> torch.Tensor:
    """(..., 64, vb, hb) planes -> (..., vb, hb, 8, 8) blocks (a view of a
    view made by blocks_as_soa, else a copy)."""
    *lead, _, vb, hb = coefs_soa.shape
    return coefs_soa.movedim(-3, -1).reshape(*lead, vb, hb, 8, 8)


def _table_lead(qtable: torch.Tensor, lead) -> tuple:
    """The leading axes of a table per leading index: ``(..., 64)``,
    ``(..., 8, 8)`` or the broadcast form ``(..., 1, 1, 8, 8)`` that the
    reference's batch code passes; raises for any other shape."""
    shape = tuple(qtable.shape)
    if shape[-2:] == (8, 8):
        rest = shape[:-2]
        if len(rest) == len(lead) + 2 and rest[-2:] == (1, 1):
            rest = rest[:-2]
    elif shape[-1:] == (64,):
        rest = shape[:-1]
    else:
        rest = None
    if rest is None or len(rest) > len(lead) or any(
            r not in (1, d) for r, d in zip(rest[::-1], lead[::-1])):
        raise ValueError(
            f"a quant table must be (64,), (8, 8), or one per leading index of "
            f"{tuple(lead)} as (..., 64), (..., 8, 8) or (..., 1, 1, 8, 8); got {shape}")
    return rest


def check_plane_args(coefs_soa: torch.Tensor, qtable: torch.Tensor):
    """Check the arguments; return (lead, n, vb, hb, q) with q the one quant
    table as (64,) int32, or a table per leading index as (n, 64) int32."""
    if coefs_soa.dim() < 3 or coefs_soa.shape[-3] != 64:
        raise ValueError(
            f"coefficient planes must be (..., 64, vb, hb), got {tuple(coefs_soa.shape)}")
    if coefs_soa.dtype != torch.int16:
        raise TypeError(f"coefficients must be int16, got {coefs_soa.dtype}")
    *lead, _, vb, hb = coefs_soa.shape
    n = 1
    for d in lead:
        n *= d
    if n < 1 or vb < 1 or hb < 1:
        raise ValueError(f"empty coefficient planes {tuple(coefs_soa.shape)}")
    if qtable.numel() == 64:
        return lead, n, vb, hb, qtable.reshape(64).to(torch.int32)
    rest = _table_lead(qtable, lead)
    q = torch.broadcast_to(qtable.reshape(*rest, 64), (*lead, 64))
    return lead, n, vb, hb, q.reshape(n, 64).to(torch.int32)


def table_blocks(q: torch.Tensor, lead) -> torch.Tensor:
    """check_plane_args' table in the shape that broadcasts against the
    (*lead, vb, hb, 8, 8) blocks of the plain versions."""
    return q.reshape(8, 8) if q.dim() == 1 else q.reshape(*lead, 1, 1, 8, 8)


def dispatch_planes(name: str, coefs_list, qtables, reference, kernel):
    """Check the lists of planes and tables; on the CPU run ``reference``
    plane by plane, on CUDA launch ``kernel()``'s entry once
    (:func:`launch_planes_kernel`); any other device raises.  Returns
    (outputs, whether the kernel was launched)."""
    coefs_list, qtables = list(coefs_list), list(qtables)
    if not 1 <= len(coefs_list) <= MAX_PLANES or len(qtables) != len(coefs_list):
        raise ValueError(
            f"1 to {MAX_PLANES} planes with a quant table each, got {len(coefs_list)} planes "
            f"and {len(qtables)} tables")
    dev = coefs_list[0].device
    if any(t.device != dev for t in coefs_list + qtables):
        raise ValueError(f"{name}: all planes and tables must be on {dev}")
    if dev.type == "cpu":
        return [reference(c, q) for c, q in zip(coefs_list, qtables)], False
    if dev.type != "cuda":
        for c, q in zip(coefs_list, qtables):
            check_plane_args(c, q)
        raise RuntimeError(f"{name}: no kernel for device {dev}")
    return launch_planes_kernel(kernel(), name, coefs_list, qtables), True


def launch_planes_kernel(fn, name: str, coefs_list, qtables):
    """Launch ``fn`` (jgt_idct_islow_planes or jgt_idct_float_planes) once on
    up to MAX_PLANES CUDA coefficient planes, each (..., 64, vb, hb) with its
    own quant table or tables; returns the list of (..., vb*8, hb*8) uint8
    planes."""
    dev = coefs_list[0].device
    desc, outs, keep = [], [], []   # keep: alive until the launch is enqueued
    for coefs_soa, qtable in zip(coefs_list, qtables):
        lead, n, vb, hb, q = check_plane_args(coefs_soa, qtable)
        if q.device != dev or coefs_soa.device != dev:
            raise ValueError(f"{name}: all planes and quant tables must be on {dev}")
        # A view whenever the leading axes can be merged (always for a
        # contiguous tensor and for a blocks_as_soa view of one).
        x = coefs_soa.reshape(n, 64, vb, hb)
        q = q.contiguous()
        out = torch.empty((*lead, vb * 8, hb * 8), dtype=torch.uint8, device=dev)
        desc += [x.data_ptr(), q.data_ptr(), out.data_ptr(), *x.stride(), n, vb, hb,
                 0 if q.dim() == 1 else 64]
        outs.append(out)
        keep += [x, q]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn((ctypes.c_longlong * len(desc))(*desc), len(outs), stream)
    del keep
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    return outs
