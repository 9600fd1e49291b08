"""A dry run of every sharded path on one (data, space) mesh.

The port of the test-side ``dryrun_multichip`` of the repo's
``__graft_entry__.py``.  Four checks, each output bit-identical to the
unsharded decode of the same input on the mesh's first device:

1. ``parallel/shard.decode_batch_sharded`` on a 64x64 4:2:0 batch, with its
   checksum against the sum of the output samples mod 2**32;
2. ``engine/device_entropy.decode_image_device_sharded``, fancy, with a
   restart marker every MCU and without restart markers;
3. ``engine/batch.decode_batch(mesh=..., entropy="device")`` on n + 1
   distinct images (a count the grid does not divide);
4. BASELINE config 5's 8K 4:2:0 block grid (luma 540x960 blocks, chroma
   270x480) with sparse seeded coefficients through the sharded fancy
   pixel stage, the halo seam rows included.

``tests/test_torch_multichip.py`` runs it on a CPU mesh, ``chip_smoke.py``
on the card.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from jpeg_gpu_tpu_torch.engine import batch, pipeline
from jpeg_gpu_tpu_torch.engine.device_entropy import (
    decode_image_device,
    decode_image_device_sharded,
)
from jpeg_gpu_tpu_torch.engine.pipeline import PipelineSpec
from jpeg_gpu_tpu_torch.host.parser import parse
from jpeg_gpu_tpu_torch.parallel.mesh import DATA_AXIS, SPACE_AXIS, make_mesh
from jpeg_gpu_tpu_torch.parallel.shard import decode_batch_sharded
from jpeg_gpu_tpu_torch.testing import corpus

# BASELINE config 5: an 8K 4:2:0 frame, MCUs of 16x16 pixels.
FRAME_8K = (4320, 7680)


def _batch_inputs(parsed, n: int, device):
    """Host entropy of one frame as an (n, vb, hb, 8, 8) batch per component,
    and its (8, 8) quant tables, on ``device``."""
    from jpeg_gpu_tpu_torch.host.entropy import decode_scan

    hdr = parsed.header
    coefs = tuple(
        torch.from_numpy(np.ascontiguousarray(c, dtype=np.int16)).to(device).expand(n, *c.shape)
        .contiguous()
        for c in decode_scan(parsed).coefs)
    qts = tuple(torch.from_numpy(hdr.quant_for(c).values.astype(np.int32)).to(device)
                for c in hdr.components)
    return coefs, qts


def _sparse_8k_coefs(qtable_header):
    """The 8K 4:2:0 spec and seeded sparse coefficients on its block grid:
    full-range DC and a little AC energy, so that every output row depends
    on its own blocks and a wrong halo row cannot cancel."""
    h, w = FRAME_8K
    spec = PipelineSpec(
        width=w, height=h,
        comp_sizes=((w, h), (w // 2, h // 2), (w // 2, h // 2)),
        comp_decs=((0, 0), (1, 1), (1, 1)),
        comp_samps=((2, 2), (1, 1), (1, 1)),
        exact=True, upsample="fancy",
    )
    rng = np.random.default_rng(0)
    coefs = []
    for vs, hs in ((2, 2), (1, 1), (1, 1)):
        vb = (h // 16 * vs, w // 16 * hs)
        plane = np.zeros(vb + (8, 8), dtype=np.int16)
        plane[..., 0, 0] = rng.integers(-1024, 1024, vb, dtype=np.int16)
        plane[..., 0, 1] = rng.integers(-64, 64, vb, dtype=np.int16)
        plane[..., 1, 0] = rng.integers(-64, 64, vb, dtype=np.int16)
        plane[..., 7, 7] = rng.integers(-8, 8, vb, dtype=np.int16)
        coefs.append(plane)
    qts = [qtable_header.quant_for(c).values.astype(np.int32)
           for c in qtable_header.components]
    return spec, coefs, qts


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None) -> dict:
    """The four checks on a mesh of ``n_devices`` of ``devices`` (None: the
    visible cards), with a space axis of 2 where ``n_devices`` is even and
    above 1, else 1.  Raises AssertionError on a mismatch; returns a
    summary."""
    space = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = make_mesh(n_devices, space=space, devices=devices)
    first = mesh.first_device
    data = mesh.shape[DATA_AXIS]
    summary = {"mesh": (data, mesh.shape[SPACE_AXIS])}

    # 1. The batched pixel stage, with its checksum.
    img = corpus.synthetic_rgb(64, 64, seed=0)
    parsed = parse(corpus.own_jpeg(img, "4:2:0", quality=85).data)
    spec = PipelineSpec.from_header(parsed.header)
    coefs, qts = _batch_inputs(parsed, data, first)
    rgb, checksum = decode_batch_sharded(spec, mesh, coefs, qts)
    assert tuple(rgb.shape) == (data, 64, 64, 3), tuple(rgb.shape)
    want = pipeline.decode_rgb(spec, coefs, qts)
    assert torch.equal(rgb[:, :64, :64], want), "sharded batch != unsharded"
    assert int(checksum) == int(rgb.sum(dtype=torch.int64)) & 0xFFFFFFFF
    summary["batch_checksum"] = int(checksum)

    # 2. One image on the device, sharded, fancy: restart markers, and none.
    for name, interval in (("restart", 1), ("no_restart", 0)):
        data_ = corpus.own_jpeg(corpus.synthetic_rgb(64, 64, seed=1), "4:2:0",
                                quality=85, restart_interval=interval).data
        got = decode_image_device_sharded(parse(data_), mesh, upsample="fancy")
        want = decode_image_device(parse(data_), upsample="fancy", device=first)
        assert np.array_equal(got, want.cpu().numpy()), f"sharded image ({name}) != unsharded"
        summary[f"image_{name}"] = got.shape

    # 3. A corpus of n + 1 distinct images with their own tables.
    datas = [corpus.own_jpeg(corpus.synthetic_rgb(64, 64, seed=10 + i), "4:2:0",
                             quality=70 + (5 * i) % 30, restart_interval=1).data
             for i in range(n_devices + 1)]
    outs = batch.decode_batch(datas, mesh=mesh, entropy="device")
    wants = batch.decode_batch_device(datas, device=first)
    assert len(outs) == n_devices + 1
    assert all(np.array_equal(a, b) for a, b in zip(outs, wants)), "sharded corpus != unsharded"
    summary["corpus_images"] = len(outs)

    # 4. The 8K 4:2:0 block grid through the sharded fancy pixel stage.
    spec8k, coefs8k, qts8k = _sparse_8k_coefs(parsed.header)
    qts8k = tuple(torch.from_numpy(q).to(first) for q in qts8k)
    one = tuple(torch.from_numpy(c).to(first)[None] for c in coefs8k)
    rgb8k, csum8k = decode_batch_sharded(
        spec8k, mesh, tuple(c.expand(data, *c.shape[1:]) for c in one), qts8k)
    want8k = pipeline.decode_rgb(spec8k, one, qts8k)[0]
    assert torch.equal(rgb8k[0, : FRAME_8K[0], : FRAME_8K[1]], want8k), \
        "8K sharded fancy != unsharded"
    summary["frame_8k"] = tuple(rgb8k.shape)
    summary["frame_8k_checksum"] = int(csum8k)
    return summary


def distributed_worker(rank: int, world_size: int, init_method: str, datas, space: int,
                       device: str, out_dir: str) -> None:
    """One rank of a multi-process ``decode_batch_distributed`` run, for
    ``torch.multiprocessing.spawn``: joins the group at ``init_method``
    (a ``file://`` rendezvous), decodes its contiguous share of ``datas``
    and writes its RGB arrays and the global checksum to
    ``out_dir/rank{rank}.npz``."""
    import torch.distributed as dist

    from jpeg_gpu_tpu_torch.parallel import distributed

    torch.set_num_threads(1)
    assert distributed.initialize_from_env(
        init_method=init_method, world_size=world_size, rank=rank, device=device)
    try:
        mine = datas[distributed.local_shard(len(datas))]
        rgbs, checksum = distributed.decode_batch_distributed(
            mine, space=space, device=device, return_checksum=True)
        np.savez(f"{out_dir}/rank{rank}.npz", checksum=checksum, *rgbs)
    finally:
        dist.destroy_process_group()
