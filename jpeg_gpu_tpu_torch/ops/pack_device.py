"""K4: device expander for the PACK upload: (run, value) streams -> dense coefs.

The port of ``jpeg_gpu_tpu/ops/pack_device.py``.  The host uploads only the
run-length packed entropy symbols (2 bytes per non-zero coefficient) and the
device expands them to dense coefficients.  Per block the stream holds a u16
``DC & 0xfff`` entry (absolute DC in 12-bit two's complement, so blocks are
position-independent), then ``run << 12 | value & 0xfff`` per non-zero AC
coefficient, then ``0x0000`` as end of block (left out when the block fills
to position 63).  The layouts are the reference's:

* streams ``(B, NW, 8, 128)`` int32 -- two u16 entries per word, the high
  half first; word w of lane ``b*1024 + s*128 + l`` at ``[b, w, s, l]``
  (host/pack_plan.py; a ``PackPlan.streams`` array of either package, turned
  into a tensor by ``ops.entropy_device.plan_tensors``);
* coefficients ``(B, T, 64, 8, 128)`` int16 -- natural-order coefficients of
  block t of that lane, T = MCUs per lane * blocks per MCU.

On a CUDA tensor :func:`expand_pack_device` launches the hand-written
kernel ``csrc/pack_expand.cu``: one thread per lane, the rows streamed
through shared memory ahead of the walk, the output cleared by the kernel
itself and the values stored straight to their rows, in one launch.  On a
CPU tensor it runs the plain PyTorch version :func:`expand_pack_reference`,
which advances all lanes in lockstep.  Both give identical coefficients.
"""

from __future__ import annotations

import ctypes

import torch

from jpeg_gpu_tpu_torch.ops.entropy_device import LANES, SLOTS, SUBLANES, u32
from jpeg_gpu_tpu_torch.ops.zigzag import DEZIGZAG

# Kernel launches since the last reset (set to 0 to start counting).
launches = 0


def _check_args(streams: torch.Tensor, blocks_per_segment: int) -> None:
    if streams.dim() != 4 or tuple(streams.shape[2:]) != (SUBLANES, LANES):
        raise ValueError(f"streams must be (B, NW, 8, 128), got {tuple(streams.shape)}")
    if streams.dtype != torch.int32:
        raise TypeError(f"streams must be int32, got {streams.dtype}")
    if streams.shape[0] < 1 or streams.shape[1] < 1:
        raise ValueError(f"empty streams {tuple(streams.shape)}")
    if blocks_per_segment < 1:
        raise ValueError(f"blocks_per_segment must be >= 1, got {blocks_per_segment}")


def _sign12(v: torch.Tensor) -> torch.Tensor:
    """12-bit two's complement -> signed value."""
    return torch.where(v >= 0x800, v - 0x1000, v)


def expand_pack_reference(streams: torch.Tensor, blocks_per_segment: int) -> torch.Tensor:
    """Plain PyTorch version of K4, on any device.

    Every lane advances in lockstep, block by block and one entry per
    iteration; the AC loop stops once every lane has ended its block.  A
    read past the row gives 0 (DC 0, end of block), as the kernel's does.
    """
    _check_args(streams, blocks_per_segment)
    dev = streams.device
    b, nw = streams.shape[0], streams.shape[1]
    n = b * SLOTS
    rows = u32(streams.reshape(b, nw, SLOTS).permute(0, 2, 1).reshape(n, nw))
    # (N, 2*NW) u16 entries, the high half of each word first.
    entries = torch.stack([rows >> 16, rows & 0xFFFF], dim=-1).reshape(n, 2 * nw)
    pos = torch.zeros(n, dtype=torch.int64, device=dev)
    natural = torch.as_tensor(DEZIGZAG, dtype=torch.int64, device=dev)
    out = torch.zeros((b, blocks_per_segment, 64, SLOTS), dtype=torch.int16, device=dev)

    def next_entry(pos, active):
        inside = pos < 2 * nw
        e = torch.gather(entries, 1, torch.clamp(pos, max=2 * nw - 1).unsqueeze(1))
        return torch.where(inside, e.squeeze(1), 0), torch.where(active, pos + 1, pos)

    always = torch.ones(n, dtype=torch.bool, device=dev)
    for t in range(blocks_per_segment):
        entry, pos = next_entry(pos, always)
        coef = torch.zeros((n, 64), dtype=torch.int64, device=dev)   # zig-zag order
        coef[:, 0] = _sign12(entry & 0xFFF)
        k = torch.zeros(n, dtype=torch.int64, device=dev)
        active = always
        for _ in range(63):
            if not bool(active.any()):
                break
            entry, pos = next_entry(pos, active)
            coded = active & (entry != 0)
            newk = k + (entry >> 12) + 1
            write = coded & (newk <= 63)
            coef.scatter_add_(
                1, torch.clamp(newk, max=63).unsqueeze(1),
                torch.where(write, _sign12(entry & 0xFFF), 0).unsqueeze(1),
            )
            k = torch.where(coded, torch.clamp(newk, max=63), k)
            active = coded & (k < 63)
        out[:, t] = coef[:, natural].to(torch.int16).reshape(b, SLOTS, 64).permute(0, 2, 1)
    return out.reshape(b, blocks_per_segment, 64, SUBLANES, LANES)


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        from jpeg_gpu_tpu_torch import cuda_build

        lib = cuda_build.load("pack_expand")
        lib.jgt_pack_expand.restype = ctypes.c_int
        lib.jgt_pack_expand.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p
        ]
        _lib = lib
    return _lib


def expand_pack_device(
    streams: torch.Tensor,      # (B, NW, 8, 128) int32
    blocks_per_segment: int,    # T
) -> torch.Tensor:
    """Expand packed streams -> (B, T, 64, 8, 128) int16 natural-order coefs.

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    dev = streams.device
    if dev.type == "cpu":
        return expand_pack_reference(streams, blocks_per_segment)
    if dev.type != "cuda":
        raise RuntimeError(f"expand_pack_device: no kernel for device {dev}")
    _check_args(streams, blocks_per_segment)
    streams = streams.contiguous()
    b, nw = streams.shape[0], streams.shape[1]
    # The kernel writes every element: zeros first, then the values.
    out = torch.empty(
        (b, blocks_per_segment, 64, SUBLANES, LANES), dtype=torch.int16, device=dev
    )
    lib = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.jgt_pack_expand(
            streams.data_ptr(), out.data_ptr(), b, nw, blocks_per_segment, stream
        )
    if rc != 0:
        raise RuntimeError(f"pack_expand kernel launch failed: CUDA error {rc}")
    global launches
    launches += 1
    return out
