"""Coefficient planes in, raster plane out: what the two standalone IDCT
kernels (K5 ``idct_islow_plane``, K6 ``idct_float``) share on the Python side.

Both take int16 SoA coefficient planes ``(..., 64, vb, hb)`` -- plane j holds
natural-order coefficient j of every block -- and one quant table per plane,
and write the ``(..., vb*8, hb*8)`` uint8 raster plane.  K6 is launched once
per plane (:func:`launch_plane_kernel`); K5 once for all planes of a frame
(:func:`launch_planes_kernel`, up to MAX_PLANES descriptors in one call).  The kernels address their
input through element strides (``csrc/block_plane.cuh``), so the block
layout ``(..., vb, hb, 8, 8)`` that host entropy and the assembly pass
produce goes in as a view (:func:`blocks_as_soa`), without a transposing
copy.
"""

from __future__ import annotations

import ctypes

import torch

MAX_PLANES = 4   # csrc/block_plane.cuh:kMaxPlanes


def blocks_as_soa(coefs: torch.Tensor) -> torch.Tensor:
    """(..., vb, hb, 8, 8) blocks -> (..., 64, vb, hb) planes, as a view."""
    *lead, vb, hb, _, _ = coefs.shape
    return coefs.reshape(*lead, vb, hb, 64).movedim(-1, -3)


def soa_as_blocks(coefs_soa: torch.Tensor) -> torch.Tensor:
    """(..., 64, vb, hb) planes -> (..., vb, hb, 8, 8) blocks (a view of a
    view made by blocks_as_soa, else a copy)."""
    *lead, _, vb, hb = coefs_soa.shape
    return coefs_soa.movedim(-3, -1).reshape(*lead, vb, hb, 8, 8)


def check_plane_args(coefs_soa: torch.Tensor, qtable: torch.Tensor):
    """Check the arguments; return (lead, n, vb, hb, q) with the one quant
    table as (64,) int32."""
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
    if qtable.numel() != 64:
        raise ValueError(f"one quant table of 64 entries, got {tuple(qtable.shape)}")
    return lead, n, vb, hb, qtable.reshape(64).to(torch.int32)


PLANE_ARGTYPES = (
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 4
    + [ctypes.c_void_p]
)


def launch_plane_kernel(fn, name: str, coefs_soa: torch.Tensor, qtable: torch.Tensor):
    """Launch ``fn`` (jgt_idct_islow_plane or jgt_idct_float_plane) on CUDA
    coefficient planes; returns the (..., vb*8, hb*8) uint8 plane."""
    dev = coefs_soa.device
    lead, n, vb, hb, q = check_plane_args(coefs_soa, qtable)
    if q.device != dev:
        raise ValueError(f"{name}: the quant table must be on {dev}")
    if n > 65535:
        raise ValueError(f"{name}: at most 65535 leading indices, got {n}")
    # A view whenever the leading axes can be merged (always for a
    # contiguous tensor and for a blocks_as_soa view of one).
    x = coefs_soa.reshape(n, 64, vb, hb)
    q = q.contiguous()
    out = torch.empty((*lead, vb * 8, hb * 8), dtype=torch.uint8, device=dev)
    sn, sj, sr, sc = x.stride()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            x.data_ptr(), q.data_ptr(), out.data_ptr(),
            n, vb, hb, sn, sj, sr, sc, stream,
        )
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    return out


def launch_planes_kernel(fn, name: str, coefs_list, qtables):
    """Launch ``fn`` (jgt_idct_islow_planes) once on up to MAX_PLANES CUDA
    coefficient planes, each (..., 64, vb, hb) with its own quant table;
    returns the list of (..., vb*8, hb*8) uint8 planes."""
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
        desc += [x.data_ptr(), q.data_ptr(), out.data_ptr(), *x.stride(), n, vb, hb]
        outs.append(out)
        keep += [x, q]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn((ctypes.c_longlong * len(desc))(*desc), len(outs), stream)
    del keep
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    return outs
