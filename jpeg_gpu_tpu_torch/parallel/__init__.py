"""Sharding over a (data, space) grid of devices, and the multi-process glue.

The port of ``jpeg_gpu_tpu/parallel/``: :mod:`.mesh` (the grid and its
split and gather helpers), :mod:`.shard` (the sharded decodes) and
:mod:`.distributed` (one rank per card over ``torch.distributed``).
"""
