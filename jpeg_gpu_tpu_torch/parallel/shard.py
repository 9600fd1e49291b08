"""Sharded decodes over the (data, space) mesh.

The port of ``jpeg_gpu_tpu/parallel/shard.py``.  Images shard over the
``data`` axis and MCU block rows over the ``space`` axis.  One process
drives every shard (``parallel/mesh.py``): each function below loops over
the grid, runs a shard's kernels on that shard's device, and stands for the
reference's collectives with copies -- the one-row halo of the fancy
filters (``ppermute``) is ``row.to(neighbour)``, an ``all_gather`` is a
``torch.cat`` of the shards on the receiving device, the checksum's
``psum`` a sum of the shards' partial sums.  Nothing in a loop waits for a
device.

Nearest upsampling never crosses an MCU row, so the pixel stage needs no
traffic between space shards; the fancy filters read one chroma row above
and below each shard, and those rows come from the neighbours after each
shard has clamped its rows past the true plane height (clamp, then
exchange, as the reference orders them).

Where the reference runs a step on every shard of the grid because
``shard_map`` is SPMD, the port runs it once per shard that needs it: an
image's Huffman decode runs once per data shard (not once per data and
space shard), and its pixel stage once per space shard; what every shard
of the reference computes redundantly (the gathered coefficients, the
assembly, the device index scan) is computed once per distinct device.
The kernels are the ones the unsharded paths launch: K2's row form
(``ops/entropy_device``), K3 (``ops/specsync_device``), K1 on a slice of
MCU rows (``ops/pixel_fused``), K5 or K6 (``engine/pipeline._sample_planes``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from jpeg_gpu_tpu_torch.engine import pipeline
from jpeg_gpu_tpu_torch.engine.pipeline import PipelineSpec, fused_rgb_geometry
from jpeg_gpu_tpu_torch.ops import color as color_ops
from jpeg_gpu_tpu_torch.ops import entropy_device, pixel_fused, specsync_device
from jpeg_gpu_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    SPACE_AXIS,
    Mesh,
    all_gather,
    distinct,
    split,
    to,
)

_U32 = 0xFFFFFFFF


def check_space_rows(nvmb: int, geom: Sequence[Tuple[int, int]], space: int) -> None:
    """Every component's block rows must split evenly over the space axis,
    or the row slices would drop bottom MCU rows and misalign luma against
    chroma."""
    for _hs, vs in geom:
        if (nvmb * vs) % space:
            raise ValueError(
                f"MCU rows ({nvmb}, x{vs} blocks) not divisible by the "
                f"space axis ({space}); use a smaller space axis"
            )


# -- the pixel stage ---------------------------------------------------------

def _clamp_true_rows(plane: torch.Tensor, true_h: int, idx: int) -> torch.Tensor:
    """Replicate the last true sample row into the MCU padding rows of space
    shard ``idx`` (rows ``idx * r`` on, r the shard's rows).

    Fancy filters read neighbour rows, so the padding below the true
    component height must be edge-replicated before halos are exchanged.
    As in the reference, a shard clamps only against rows it holds.
    """
    r = plane.shape[-2]
    base = idx * r
    if base + r <= true_h:
        return plane           # entirely above the boundary: identity
    iota = torch.arange(r, device=plane.device)
    local_limit = min(max(true_h - 1 - base, 0), r - 1)
    rows = torch.where(base + iota <= true_h - 1, iota, torch.clamp(iota, max=local_limit))
    return plane.index_select(-2, rows)


def _halo_rows(planes: Sequence[torch.Tensor]):
    """Per space shard, the row above its first row and the row below its
    last, from the neighbour shards (the reference's two ``ppermute``s);
    the edge shards replicate their own edge row."""
    n = len(planes)
    halos = []
    for i, x in enumerate(planes):
        top = x[..., :1, :] if i == 0 else to(planes[i - 1][..., -1:, :], x.device)
        bot = x[..., -1:, :] if i == n - 1 else to(planes[i + 1][..., :1, :], x.device)
        halos.append((top, bot))
    return halos


def _interleave(even: torch.Tensor, odd: torch.Tensor, dim: int) -> torch.Tensor:
    dim = dim % even.ndim
    shape = list(even.shape)
    shape[dim] *= 2
    return torch.stack([even, odd], dim=dim + 1).reshape(shape)


def _fancy_v_halo(plane: torch.Tensor, top: torch.Tensor, bot: torch.Tensor) -> torch.Tensor:
    """Vertical triangle column sums of one shard: the interleaved
    (..., 2r, w) int32 sums 3*this + other, with the rows above and below
    the shard from :func:`_halo_rows`."""
    x = plane.to(torch.int32)
    above = torch.cat([top.to(torch.int32), x[..., :-1, :]], dim=-2)
    below = torch.cat([x[..., 1:, :], bot.to(torch.int32)], dim=-2)
    return _interleave(3 * x + above, 3 * x + below, -2)


def _clamp_width(x: torch.Tensor, true_w: int) -> torch.Tensor:
    cols = torch.clamp(torch.arange(x.shape[-1], device=x.device), max=true_w - 1)
    return x.index_select(-1, cols)


def _fancy_h_from_colsums(colsum: torch.Tensor, true_w: int) -> torch.Tensor:
    """Horizontal pass of the 4:2:0 fancy filter on the column sums."""
    cs = _clamp_width(colsum, true_w)           # replicate past the true width
    left = torch.cat([cs[..., :1], cs[..., :-1]], dim=-1)
    right = torch.cat([cs[..., 1:], cs[..., -1:]], dim=-1)
    even = (3 * cs + left + 8) >> 4
    odd = (3 * cs + right + 7) >> 4
    return _interleave(even, odd, -1).to(torch.uint8)


def _fancy_h1v2_from_colsums(colsum: torch.Tensor, true_w: int) -> torch.Tensor:
    """4:4:0 vertical-only fancy: (3*this + other + 1 | 2) >> 2, the even
    output rows rounding with 1 and the odd with 2."""
    cs = _clamp_width(colsum, true_w)
    rounding = 1 + (torch.arange(cs.shape[-2], device=cs.device) % 2)
    return ((cs + rounding[:, None]) >> 2).to(torch.uint8)


def _upsample_sharded(planes: Sequence[torch.Tensor], spec: PipelineSpec, ci: int):
    """Chroma upsampling of component ``ci`` over the space shards of one
    data row (``planes[s]`` on shard s's device), as engine/pipeline.py
    upsamples the whole plane."""
    xdec, ydec = spec.comp_decs[ci]
    if spec.upsample != "fancy" or (xdec, ydec) == (0, 0):
        return [color_ops.upsample_nearest(p, xdec, ydec) for p in planes]
    cw, ch = spec.comp_sizes[ci]
    planes = [_clamp_true_rows(p, ch, i) for i, p in enumerate(planes)]
    if (xdec, ydec) in ((1, 1), (0, 1)):
        finish = _fancy_h_from_colsums if xdec else _fancy_h1v2_from_colsums
        return [finish(_fancy_v_halo(p, top, bot), cw)
                for p, (top, bot) in zip(planes, _halo_rows(planes))]
    if (xdec, ydec) == (1, 0):
        return [color_ops.upsample_fancy_h2(_clamp_width(p, cw), dim=-1) for p in planes]
    return [color_ops.upsample_nearest(p, xdec, ydec) for p in planes]  # 4:1:1 replicates


def _local_decode_rgb(spec: PipelineSpec, shards) -> List[torch.Tensor]:
    """Decode the space shards of one data row to RGB.

    ``shards[s]`` is (coefs, qtables) on shard s's device: per component
    (..., rows, hb, 8, 8) blocks -- its MCU-aligned block rows -- and a
    table, or one per image as (..., 1, 1, 8, 8).  The IDCT is one K5 launch
    per shard (K6 with ``exact=False``).  Returns the shards' MCU-padded
    (..., rows * 8 * vsamp, Wpad, 3) uint8 RGB, each on its device; the
    caller crops.
    """
    planes = [pipeline._sample_planes(spec, coefs, qtables) for coefs, qtables in shards]
    up = [_upsample_sharded([p[ci] for p in planes], spec, ci) for ci in range(spec.ncomps)]
    out = []
    for s in range(len(shards)):
        if spec.ncomps == 1:
            y = up[0][s]
            out.append(y[..., None].expand(*y.shape, 3))
        elif spec.exact:
            out.append(color_ops.ycbcr_to_rgb_exact(up[0][s], up[1][s], up[2][s]))
        else:
            out.append(color_ops.ycbcr_to_rgb_float(up[0][s], up[1][s], up[2][s]))
    return out


def decode_batch_sharded(
    spec: PipelineSpec,
    mesh: Mesh,
    coefs: Sequence[torch.Tensor],
    qtables: Sequence[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode (N, vb, hb, 8, 8) coefficient batches over the mesh.

    Images shard over ``data`` (N divisible by it), block rows over
    ``space``.  Per-image (N, 1, 1, 8, 8) quant tables shard with the batch;
    shared (8, 8) tables go to every shard.

    Returns (rgb, checksum) on the mesh's first device: rgb (N, Hpad, Wpad,
    3) uint8, still MCU-padded (callers crop ``[:, :H, :W]``); checksum the
    decode signature, the sum of every output sample mod 2**32 (the
    reference's uint32 ``psum``), as an int64 scalar tensor.
    """
    data, space = mesh.shape[DATA_AXIS], mesh.shape[SPACE_AXIS]
    for ci, c in enumerate(coefs):
        if c.shape[-4] % space:
            raise ValueError(
                f"component {ci} block rows ({c.shape[-4]}) not divisible by the "
                f"space axis ({space}); use a smaller space axis"
            )
    first = mesh.first_device
    data_coefs = [split(c, data) for c in coefs]
    data_q = [split(q, data) if q.dim() == 5 else [q] * data for q in qtables]
    rows, partial = [], []
    for d in range(data):
        shards = []
        for s, dev in enumerate(mesh.devices[d]):
            local = tuple(to(split(c[d], space, dim=-4)[s], dev) for c in data_coefs)
            shards.append((local, tuple(to(q[d], dev) for q in data_q)))
        rgbs = _local_decode_rgb(spec, shards)
        partial += [to(r.sum(dtype=torch.int64), first) for r in rgbs]
        rows.append(all_gather(rgbs, first, dim=-3))
    rgb = all_gather(rows, first, dim=0)
    checksum = torch.stack(partial).sum() & _U32
    return rgb, checksum


# -- from coefficients to the pixel shards -----------------------------------

def _qtable_pair(qtables):
    """K1's (n, 64) luma and (n, 2, 64) chroma tables (n = 1 for shared)."""
    qty = qtables[0].reshape(-1, 64)
    qtc = torch.stack([qtables[1].reshape(-1, 64), qtables[2].reshape(-1, 64)], dim=1)
    return qty, qtc


def _pixel_row(spec, fg, comps: Dict[torch.device, tuple], devices, qtables):
    """The pixel stage of one data row: space shard s takes its block rows
    of the assembled components on its device (``comps[devices[s]]``) and
    decodes them; returns the row's RGB shards.

    Fused nearest geometries run K1 on each shard's MCU rows (the SoA planes
    share their MCU-row axis, -2, across components; the slice goes to the
    kernel as a contiguous copy, and K1 returns exactly its rows, with none
    of the band padding the reference's kernel appends); the others run
    :func:`_local_decode_rgb`, fancy with the real halo."""
    space = len(devices)
    if fg is not None:
        sx, sy = fg
        out = []
        for s, dev in enumerate(devices):
            y, cb, cr = comps[dev]
            rows = y.shape[-2] // space
            y, cb, cr = (c[..., s * rows:(s + 1) * rows, :].contiguous() for c in (y, cb, cr))
            lead = cb.shape[:-5]
            qty, qtc = _qtable_pair([to(q, dev) for q in qtables])
            out.append(pixel_fused.decode_rgb_fused_soa(
                y, cb.reshape(*lead, 64, rows, -1), cr.reshape(*lead, 64, rows, -1),
                qty, qtc, sx, sy))
        return out
    shards = []
    for s, dev in enumerate(devices):
        local = []
        for c in comps[dev]:
            rows = c.shape[-4] // space
            local.append(c[..., s * rows:(s + 1) * rows, :, :, :])
        shards.append((tuple(local), tuple(to(q, dev) for q in qtables)))
    return _local_decode_rgb(spec, shards)


def _gathered(parts, devices, assemble, post=None) -> Dict[torch.device, tuple]:
    """The all_gather of ``parts`` onto each distinct device of ``devices``,
    then ``post`` (may update in place) and ``assemble`` on each: what every
    shard of the reference computes, done once per device."""
    gathered = {dev: all_gather(parts, dev) for dev in distinct(devices)}
    # Every copy is enqueued before any in-place post-pass touches a source.
    out = {}
    for dev, g in gathered.items():
        if post is not None:
            g = post(g)
        out[dev] = assemble(g)
    return out


def _local_seg_meta(seg_meta: torch.Tensor, base: int, local_b: int) -> torch.Tensor:
    """seg_meta with its batch index made shard-local: K2 suppresses the
    padded tail flags of the (possibly short) last segment only on the shard
    that holds it; elsewhere -1, which matches no batch."""
    lb = seg_meta[:1] - base
    keep = (lb >= 0) & (lb < local_b)
    return torch.cat([torch.where(keep, lb, torch.full_like(lb, -1)), seg_meta[1:]])


def _assembler(assemble_args, fg):
    """assemble_components with a sharded function's geometry: K1's SoA
    planes for a fused geometry ``fg``, else blocks."""
    n_segments, mcus_per_segment, n_mcus, nhmb, nvmb, geom, frame_order = assemble_args

    def assemble(out):
        return entropy_device.assemble_components(
            out, n_segments, mcus_per_segment, n_mcus, nhmb, nvmb, geom,
            soa=fg is not None, frame_order=frame_order,
        )
    return assemble


def decode_image_device_sharded(
    spec: PipelineSpec,
    mesh: Mesh,
    assemble_args: Tuple,        # (n_segments, mcus_per_segment, n_mcus, nhmb,
    #                               nvmb, geom, frame_order)
    streams: torch.Tensor,       # (B, NW, 8, 128) int32, B divisible by data
    plan_tables: Sequence[torch.Tensor],  # DeviceScanPlan.kernel_tables
    qtables: Sequence[torch.Tensor],
    dc_base: Optional[torch.Tensor] = None,   # (B, 8, 128, C) int32, pseudo segments
    lut: Optional[torch.Tensor] = None,       # K2's symbol tables of plan_tables
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One image, on the device, sharded: restart-segment batches shard over
    ``data`` (each data shard runs K2's row form on its own batches, on the
    device of its first space shard), the coefficients are gathered,
    assembled, and the pixel stage splits MCU block rows over ``space``.
    DRI-less pseudo segments carry per-batch DC bases (``dc_base``), added on
    each shard before the gather.

    Returns (rgb, err) on the mesh's first device: rgb (padH, padW, 3)
    uint8; err (B, 8, 128) segment flags.
    """
    n_segments, mps, n_mcus, nhmb, nvmb, geom, frame_order = assemble_args
    data, space = mesh.shape[DATA_AXIS], mesh.shape[SPACE_AXIS]
    # The fused fancy path cannot run sharded (its halos would replicate at
    # shard seams); fancy takes the unfused pipeline with real halos.
    fg = fused_rgb_geometry(spec) if spec.upsample == "nearest" else None
    check_space_rows(nvmb, geom, space)
    local_b = streams.shape[0] // data
    outs, errs = [], []
    for d, part in enumerate(split(streams, data)):
        dev = mesh.devices[d][0]
        tabs = [to(t, dev) for t in plan_tables]
        meta = _local_seg_meta(tabs[3], d * local_b, local_b)
        out, err = entropy_device.decode_segments_device(
            to(part, dev), *tabs[:3], meta, *tabs[4:],
            lut=None if lut is None else to(lut, dev))
        if dc_base is not None:
            out = entropy_device.apply_dc_base(out, to(split(dc_base, data)[d], dev), tabs[0])
        outs.append(out)
        errs.append(err)
    comps = _gathered(outs, mesh.devices[0], _assembler(assemble_args, fg))
    rgbs = _pixel_row(spec, fg, comps, mesh.devices[0], qtables)
    first = mesh.first_device
    return all_gather(rgbs, first, dim=-3), all_gather(errs, first)


def decode_image_device_sharded_spec(
    spec: PipelineSpec,
    mesh: Mesh,
    assemble_args: Tuple,        # (n_segments, 1, n_mcus, nhmb, nvmb, geom, frame_order)
    scan_cfg: Tuple,             # (sb, maxrec, nw, spw, nws, t_last): SpecScanInput
    windows: torch.Tensor,       # (BS, NWS, 8, 128) int32
    n_bits: int,
    scan_maps: Sequence[torch.Tensor],    # (dcslot_of_c, acslot_of_c)
    plan_tables: Sequence[torch.Tensor],  # (comp, dcslot, acslot maps, seg_meta,
    #                                        cbase, counts, symbols)
    qtables: Sequence[torch.Tensor],
    luts: Tuple[Optional[torch.Tensor], Optional[torch.Tensor]] = (None, None),  # (K2, K3)
):
    """A stream without restart markers, sharded, through the device index
    scan: K3 runs once on each distinct device of the data shards (its
    result is the same everywhere), each data shard gathers its contiguous
    share of the per-MCU streams (whole batches of 1024) and runs K2's row
    form on them, the coefficients are gathered, and the DC predictor bases
    are derived from the gathered coefficients (the same exclusive sum on
    each device, no extra transfer) before assembly and the space split.

    This is the reference's chain (gather -> row form -> DC bases), not K2's
    fused form, whose DC pass sums predictors inside one call only.

    Returns (rgb, err) on the mesh's first device: rgb (padH, padW, 3);
    err (B2, 8, 128) flags, B2 the MCU batches padded to the data axis; or
    None when the scan did not converge or a pseudo segment outgrows its
    row (the caller then falls back to the serial scan).  The scan's verdict
    is read on the host before any row is gathered or decoded.
    """
    n_segments, mps, n_mcus, nhmb, nvmb, geom, frame_order = assemble_args
    sb, maxrec, nw, spw, nws, t_last = scan_cfg
    assert mps == 1
    data, space = mesh.shape[DATA_AXIS], mesh.shape[SPACE_AXIS]
    fg = fused_rgb_geometry(spec) if spec.upsample == "nearest" else None
    check_space_rows(nvmb, geom, space)
    b2 = -(-n_mcus // entropy_device.SLOTS)
    b2 = -(-b2 // data) * data                        # whole batches per shard
    loc = (b2 // data) * entropy_device.SLOTS
    k2_lut, k3_lut = luts
    scans = {}
    for dev in distinct([row[0] for row in mesh.devices]):
        w = to(windows, dev)
        dc_c, ac_c = (to(t, dev) for t in scan_maps)
        cbase, counts, symbols = (to(t, dev) for t in plan_tables[4:])
        bitpos, ok, _stats = specsync_device.device_index_scan(
            w, n_bits, dc_c, ac_c, cbase, counts, symbols, sb=sb, maxrec=maxrec,
            n_mcus=n_mcus, lut=None if k3_lut is None else to(k3_lut, dev))
        # Each pseudo segment, with its one-word refill overshoot, must fit
        # the nw-word rows the gather builds.
        seg_bits = torch.cat([bitpos[1:], bitpos.new_full((1,), n_bits)]) - bitpos
        ok = ok & (seg_bits.max() + 63 <= nw * 32)
        bitpos = torch.nn.functional.pad(bitpos, (0, b2 * entropy_device.SLOTS - n_mcus))
        scans[dev] = (w, bitpos, ok)
    # The verdict before anything is gathered or decoded at the scan's bit
    # positions (the same on every device: one read).
    if not bool(scans[mesh.devices[0][0]][2]):
        return None
    outs, errs = [], []
    for d in range(data):
        dev = mesh.devices[d][0]
        w, bitpos, _ = scans[dev]
        streams = specsync_device.gather_entropy_streams(
            w, bitpos[d * loc:(d + 1) * loc], nw=nw, spw=spw, nws=nws)
        tabs = [to(t, dev) for t in plan_tables]
        meta = _local_seg_meta(tabs[3], d * (b2 // data), b2 // data)
        out, err = entropy_device.decode_segments_device(
            streams, *tabs[:3], meta, *tabs[4:],
            lut=None if k2_lut is None else to(k2_lut, dev))
        outs.append(out)
        errs.append(err)

    def dc_bases(out):
        dcb = specsync_device.dc_base_from_coefs(out, t_last)
        return entropy_device.apply_dc_base(out, dcb, to(plan_tables[0], out.device))

    comps = _gathered(outs, mesh.devices[0], _assembler(assemble_args, fg), post=dc_bases)
    rgbs = _pixel_row(spec, fg, comps, mesh.devices[0], qtables)
    first = mesh.first_device
    return all_gather(rgbs, first, dim=-3), all_gather(errs, first)


def decode_corpus_device_sharded(
    spec: PipelineSpec,
    mesh: Mesh,
    meta: Tuple,                 # (b1, n_segments, mcus_per_segment, n_mcus, nhmb,
    #                               nvmb, geom, frame_order, salvage)
    streams: torch.Tensor,       # (NI*B1, NW, 8, 128); NI % (data * space) == 0
    maps: Sequence[torch.Tensor],          # (comp_map, dcslot, acslot)
    local_seg_meta: torch.Tensor,          # (NI / (data * space), 3): shard-local
    #                                        last-segment meta, the same on every
    #                                        shard (bucket images share geometry)
    tables: Sequence[torch.Tensor],        # (cbase, counts, symbols), leading NI
    qtables: Sequence[torch.Tensor],       # per component, leading NI
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A corpus bucket on the device, sharded (BASELINE config 4's shape).

    Images shard over the flattened (data, space) grid for the Huffman
    decode: each shard runs K2's row form over its images' segment batches
    with their own table sets (one table-kernel launch and one decode per
    shard), restart segments never crossing shards; with ``salvage``
    flagged segments decode to zero coefficients.  The coefficients are then
    gathered over ``space``, assembled with the image axis in front, and each
    space shard decodes its block rows of its data row's images.

    Returns (rgb, err) on the mesh's first device: rgb (NI, Hpad, Wpad, 3)
    uint8 (callers crop to (H, W)); err (NI*B1, 8, 128) segment flags.
    """
    b1, n_segments, mps, n_mcus, nhmb, nvmb, geom, frame_order, salvage = meta
    data, space = mesh.shape[DATA_AXIS], mesh.shape[SPACE_AXIS]
    fg = fused_rgb_geometry(spec) if spec.upsample == "nearest" else None
    check_space_rows(nvmb, geom, space)
    ni = streams.shape[0] // b1
    ni_loc = ni // mesh.size
    if ni % mesh.size:
        raise ValueError(f"{ni} images do not split over {mesh.size} shards")
    grid = mesh.flat()
    stream_parts = split(streams, mesh.size)
    table_parts = [split(t, mesh.size) for t in tables]
    outs, errs = [], []
    for g, dev in enumerate(grid):
        imgmap = torch.arange(ni_loc, dtype=torch.int32, device=dev).repeat_interleave(b1)
        out, err = entropy_device.decode_segments_device_multi(
            to(stream_parts[g], dev), imgmap, *(to(m, dev) for m in maps),
            to(local_seg_meta, dev), *(to(t[g], dev) for t in table_parts))
        if salvage:
            # The damage stays inside the restart boundary.
            out = torch.where((err != 0)[:, None, None], 0, out)
        outs.append(out)
        errs.append(err)
    assemble = _assembler((n_segments, mps, n_mcus, nhmb, nvmb, geom, frame_order), fg)
    q_rows = [split(q, data) for q in qtables]
    first = mesh.first_device
    rows = []
    for d, devices in enumerate(mesh.devices):
        col = outs[d * space:(d + 1) * space]
        comps = _gathered(col, devices, lambda o: assemble(
            o.reshape((o.shape[0] // b1, b1) + o.shape[1:])))
        rgbs = _pixel_row(spec, fg, comps, devices, [q[d] for q in q_rows])
        rows.append(all_gather(rgbs, first, dim=-3))
    return all_gather(rows, first), all_gather(errs, first)
