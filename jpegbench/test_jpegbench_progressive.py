"""The traffic generator's progressive files (``traffic_gen/progressive.py``)
and the loader's ``scan_script``, on the CPU; and the pools of the committed
cells, held to the bytes they had before the progressive encoder came.

Pillow (libjpeg-turbo) decodes each file; a plain decoder below (T.81 Annex
G, one bit at a time) reads its coefficients back and checks that every
segment ends on its padding and no EOBRUN crosses a restart marker.

    python -m pytest jpegbench/test_jpegbench_progressive.py -q
"""

import copy
import hashlib
import io

import numpy as np
import pytest

from jpegbench import cells, drivers, reference
from jpegbench.traffic_gen import frames, progressive

SEEDS = (1, 2**32 + 365, 2**31 + 77)
SIZES = ((256, 256), (37, 50), (61, 93))          # (height, width); two off the MCU grid
SCRIPT = [((1, 2, 3), 0, 0, 0, 1), ((1,), 1, 5, 0, 2), ((3,), 1, 63, 0, 1), ((2,), 1, 63, 0, 1),
          ((1,), 6, 63, 0, 2), ((1,), 1, 63, 2, 1), ((1, 2, 3), 0, 0, 1, 0),
          ((3,), 1, 63, 1, 0), ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0)]


def _walk(data: bytes):
    """(marker, payload, entropy segments) of each marker after SOI; after
    an SOS the scan's destuffed segments, split at RSTn, whose numbers have
    to run 0, 1, ..., 7, 0, ... in every scan."""
    assert data[:2] == b"\xff\xd8"
    out, i = [], 2
    while True:
        assert data[i] == 0xFF
        m = data[i + 1]
        if m == 0xD9:
            assert i + 2 == len(data)
            return out
        n = int.from_bytes(data[i + 2:i + 4], "big")
        payload, i = data[i + 4:i + 2 + n], i + 2 + n
        segs = []
        if m == 0xDA:
            seg = bytearray()
            while True:
                if data[i] != 0xFF:
                    seg.append(data[i])
                elif data[i + 1] == 0:
                    seg.append(0xFF)
                    i += 1
                elif 0xD0 <= data[i + 1] <= 0xD7:
                    assert data[i + 1] - 0xD0 == len(segs) % 8
                    segs.append(bytes(seg))
                    seg = bytearray()
                    i += 1
                else:
                    break
                i += 1
            segs.append(bytes(seg))
        out.append((m, payload, segs))


def _layout(data: bytes):
    """The markers after the frame header: ("DHT", class, id), ("DRI", n)
    and (component ids and table selectors, Ss, Se, Ah, Al, segments) for
    each SOS."""
    out = []
    for m, p, segs in _walk(data):
        if m == 0xC4:
            out.append(("DHT", p[0] >> 4, p[0] & 15))
        elif m == 0xDD:
            out.append(("DRI", int.from_bytes(p, "big")))
        elif m == 0xDA:
            ns = p[0]
            out.append((tuple((p[1 + 2 * j], p[2 + 2 * j]) for j in range(ns)),
                        p[1 + 2 * ns], p[2 + 2 * ns], p[3 + 2 * ns] >> 4, p[3 + 2 * ns] & 15,
                        len(segs)))
    return out


class _Bits:
    def __init__(self, seg: bytes):
        self.s, self.p = "".join(f"{b:08b}" for b in seg), 0

    def get(self, n: int) -> int:
        assert self.p + n <= len(self.s), "a segment ends inside a code"
        v = int(self.s[self.p:self.p + n] or "0", 2)
        self.p += n
        return v

    def huff(self, table: dict) -> int:
        code = 0
        for length in range(1, 17):
            code = 2 * code + self.get(1)
            if (length, code) in table:
                return table[(length, code)]
        raise AssertionError("no such code")

    def end(self) -> None:
        rest = self.s[self.p:]
        assert len(rest) < 8 and set(rest) <= {"1"}, "a segment does not end on its padding"


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if s and v < 1 << (s - 1) else v


def _decode(data: bytes):
    """(coefficients per component (vb, hb, 64) natural order on the MCU
    grid, the Huffman symbols read in each scan) of a progressive file, by
    T.81 G.2 as libjpeg's jdphuff.c reads it."""
    tables, restart, symbols = {}, 0, []
    for m, p, segs in _walk(data):
        if m == 0xC2:
            height, width = int.from_bytes(p[1:3], "big"), int.from_bytes(p[3:5], "big")
            comps = [(p[6 + 3 * j], p[7 + 3 * j] >> 4, p[7 + 3 * j] & 15) for j in range(p[5])]
            hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
            nvmb, nhmb = _ceil(height, 8 * vmax), _ceil(width, 8 * hmax)
            coefs = [np.zeros((nvmb * v, nhmb * h, 64), np.int64) for _, h, v in comps]
        elif m == 0xC4:
            j = 0
            while j < len(p):
                counts, k = p[j + 1:j + 17], j + 17
                table, code = {}, 0
                for length in range(1, 17):
                    for _ in range(counts[length - 1]):
                        table[(length, code)] = p[k]
                        code, k = code + 1, k + 1
                    code <<= 1
                tables[(p[j] >> 4, p[j] & 15)], j = table, k
        elif m == 0xDD:
            restart = int.from_bytes(p, "big")
        elif m == 0xDA:
            ns = p[0]
            sel = [([c[0] for c in comps].index(p[1 + 2 * j]), p[2 + 2 * j]) for j in range(ns)]
            ss, se, ah, al = p[1 + 2 * ns], p[2 + 2 * ns], p[3 + 2 * ns] >> 4, p[3 + 2 * ns] & 15
            if ns > 1:
                units = [[(ci, t, my * comps[ci][2] + y, mx * comps[ci][1] + x)
                          for ci, t in sel
                          for y in range(comps[ci][2]) for x in range(comps[ci][1])]
                         for my in range(nvmb) for mx in range(nhmb)]
            else:
                (ci, t), = sel
                bh = _ceil(_ceil(height * comps[ci][2], vmax), 8)
                bw = _ceil(_ceil(width * comps[ci][1], hmax), 8)
                units = [[(ci, t, y, x)] for y in range(bh) for x in range(bw)]
            per = restart or len(units)
            assert len(segs) == -(-len(units) // per)
            n_symbols = 0
            for s_i, seg in enumerate(segs):
                bits, pred, eobrun = _Bits(seg), [0] * len(comps), 0
                for unit in units[s_i * per:(s_i + 1) * per]:
                    for ci, t, y, x in unit:
                        blk = coefs[ci][y, x]
                        if ss == 0 and ah == 0:
                            s = bits.huff(tables[(0, t >> 4)])
                            n_symbols += 1
                            pred[ci] += _extend(bits.get(s), s)
                            blk[0] = pred[ci] << al
                        elif ss == 0:
                            blk[0] |= bits.get(1) << al
                        elif ah == 0:
                            eobrun, n = _ac_first(bits, tables[(1, t & 15)], blk, ss, se, al,
                                                  eobrun)
                            n_symbols += n
                        else:
                            eobrun, n = _ac_refine(bits, tables[(1, t & 15)], blk, ss, se, al,
                                                   eobrun)
                            n_symbols += n
                assert eobrun == 0, "an EOBRUN crosses a restart marker or the end of a scan"
                bits.end()
            symbols.append(n_symbols)
    return coefs, symbols


def _ac_first(bits, table, blk, ss, se, al, eobrun):
    if eobrun:
        return eobrun - 1, 0
    k, n = ss, 0
    while k <= se:
        rs = bits.huff(table)
        n += 1
        r, s = rs >> 4, rs & 15
        if s:
            k += r
            blk[reference.ZIGZAG[k]] = _extend(bits.get(s), s) * (1 << al)
            k += 1
        elif r == 15:
            k += 16
        else:
            return (1 << r) + bits.get(r) - 1, n
    return 0, n


def _ac_refine(bits, table, blk, ss, se, al, eobrun):
    def correct(pos):
        if bits.get(1) and not blk[pos] & p1:
            blk[pos] += p1 if blk[pos] >= 0 else -p1

    p1, k, n = 1 << al, ss, 0
    if not eobrun:
        while k <= se:
            rs = bits.huff(table)
            n += 1
            r, s = rs >> 4, rs & 15
            if s:
                assert s == 1
                s = p1 if bits.get(1) else -p1
            elif r != 15:
                eobrun = (1 << r) + bits.get(r)
                break
            while k <= se:
                pos = reference.ZIGZAG[k]
                if blk[pos]:
                    correct(pos)
                else:
                    r -= 1
                    if r < 0:
                        break
                k += 1
            if s:
                blk[reference.ZIGZAG[k]] = s
            k += 1
    if eobrun:
        for k in range(k, se + 1):
            if blk[reference.ZIGZAG[k]]:
                correct(reference.ZIGZAG[k])
        eobrun -= 1
    return eobrun, n


def _own_grid(f, ci):
    hmax = max(h for h, _ in f.sampling)
    vmax = max(v for _, v in f.sampling)
    hs, vs = f.sampling[ci]
    return _ceil(_ceil(f.height * vs, vmax), 8), _ceil(_ceil(f.width * hs, hmax), 8)


def _holds_its_coefficients(f):
    """The file holds the frame's coefficients: every block of a
    component's own grid whole, the MCU grid's padding blocks their DC (no
    AC scan codes them); returns the Huffman symbols of each scan."""
    got, symbols = _decode(f.data)
    for ci, (g, want) in enumerate(zip(got, f.coefs)):
        want = want.reshape(g.shape)
        bh, bw = _own_grid(f, ci)
        assert np.array_equal(g[:bh, :bw], want[:bh, :bw])
        assert np.array_equal(g[..., 0], want[..., 0])
        pad = np.ones(g.shape[:2], bool)
        pad[:bh, :bw] = False
        assert not g[pad][:, 1:].any()
    return symbols


def _pillow(data: bytes):
    Image = pytest.importorskip("PIL.Image")
    im = Image.open(io.BytesIO(data))
    return im, np.asarray(im.convert("RGB"))


@pytest.mark.parametrize("restart", [0, 1, 7])
@pytest.mark.parametrize("height,width", SIZES)
@pytest.mark.parametrize("sampling", ["4:2:0", "4:4:4"])
def test_pillow_decodes_each_file_to_the_reference(sampling, height, width, restart):
    """libjpeg-turbo (islow, fancy upsampling) decodes every progressive
    file to exactly the reference's RGB, and to what it decodes from the
    sequential file of the same coefficients."""
    for seed in SEEDS:
        f = progressive.make_frame(seed, 5, height, width, sampling, 85, restart)
        im, got = _pillow(f.data)
        assert im.info.get("progressive") and (im.height, im.width) == (height, width)
        want = reference.rgb(f.coefs, f.qtables, f.sampling, height, width, "fancy")
        assert int(np.abs(got.astype(np.int16) - want).max()) == 0
        seq = frames.make_frame(seed, 5, height, width, sampling, 85, restart, "optimal", False)
        assert all(np.array_equal(a, b) for a, b in zip(seq.coefs, f.coefs))
        assert np.array_equal(_pillow(seq.data)[1], got)


@pytest.mark.parametrize("restart", [0, 7])
@pytest.mark.parametrize("sampling,subsampling", [("4:2:0", 2), ("4:4:4", 0)])
def test_the_markers_are_pillows_progressive_files(sampling, subsampling, restart):
    """Scan for scan, the DHTs, the DRI, each SOS's components, table
    selectors, Ss, Se, Ah and Al, and the number of restart segments are
    those of the file Pillow writes with ``progressive=True`` at the size."""
    Image = pytest.importorskip("PIL.Image")
    height, width = 61, 93
    f = progressive.make_frame(SEEDS[0], 1, height, width, sampling, 85, restart)
    buf = io.BytesIO()
    px = np.random.default_rng(0).integers(0, 256, (height, width, 3), dtype=np.uint8)
    Image.fromarray(px).save(buf, "JPEG", quality=85, progressive=True, subsampling=subsampling,
                             **({"restart_marker_blocks": restart} if restart else {}))
    ours, pillows = _layout(f.data), _layout(buf.getvalue())
    assert ours == pillows
    scans = [s for s in ours if s[0] not in ("DHT", "DRI")]
    assert [(tuple(c for c, _ in s[0]),) + s[1:5] for s in scans] == SCRIPT


@pytest.mark.parametrize("restart", [0, 1, 7])
@pytest.mark.parametrize("height,width", SIZES[1:])
@pytest.mark.parametrize("sampling", ["4:2:0", "4:4:4"])
def test_each_file_holds_its_coefficients_and_facts(sampling, height, width, restart):
    f = progressive.make_frame(SEEDS[1], 2, height, width, sampling, 85, restart)
    symbols = _holds_its_coefficients(f)
    scans = [segs for m, _, segs in _walk(f.data) if m == 0xDA]
    assert len(scans) == len(symbols) == 10
    assert f.facts.symbols == sum(symbols)
    assert f.facts.segments == sum(len(s) for s in scans)
    assert f.facts.bytes == len(f.data)
    seq = frames.make_frame(SEEDS[1], 2, height, width, sampling, 85, restart, "optimal", False)
    assert (f.facts.pixels, f.facts.mcus, f.facts.blocks, f.facts.quant_bytes) == (
        seq.facts.pixels, seq.facts.mcus, seq.facts.blocks, seq.facts.quant_bytes)


def test_a_256x256_file_holds_its_coefficients():
    f = progressive.make_frame(SEEDS[2], 0, 256, 256, "4:2:0", 85, 0)
    assert sum(_holds_its_coefficients(f)) == f.facts.symbols


def _dc_only(sampling, height, width, seed):
    """Coefficients of the MCU grid with random DC values and no AC."""
    samp = frames.SAMPLING[sampling]
    hmax = max(h for h, _ in samp)
    vmax = max(v for _, v in samp)
    nvmb, nhmb = _ceil(height, 8 * vmax), _ceil(width, 8 * hmax)
    rng = np.random.default_rng(seed)
    coefs = [np.zeros((nvmb * vs, nhmb * hs, 8, 8), np.int16) for hs, vs in samp]
    for c in coefs:
        c[..., 0, 0] = rng.integers(-20, 21, c.shape[:2])
    return samp, coefs


def _frame(coefs, samp, height, width):
    q = frames.quant_tables(85)
    data, facts = progressive.encode(coefs, q, samp, height, width, 0)
    return frames.Frame(data, facts, tuple(coefs), (q[0], q[1], q[1]), samp, height, width)


def test_an_eobrun_is_cut_at_0x7fff_blocks():
    """Eight rows of 4,096 blocks without AC values: each AC scan sends an
    EOBRUN of 32,767 blocks and one of the last block."""
    height, width = 64, 8 * 4096
    samp, coefs = _dc_only("4:4:4", height, width, 3)
    f = _frame(coefs, samp, height, width)
    assert f.facts.symbols == 3 * 32768 + 8 * 2
    _, got = _pillow(f.data)
    assert np.array_equal(got, reference.rgb(f.coefs, f.qtables, samp, height, width, "fancy"))


@pytest.mark.parametrize("sampling", ["4:2:0", "4:4:4"])
def test_an_eobrun_is_cut_when_937_correction_bits_wait(sampling):
    """Blocks whose only AC values are +-6 at zigzag positions 1-5: each
    refinement scan sends five correction bits a block and no symbol, so a
    run of 256 blocks is cut after 188 (940 bits waiting); 4:2:0's 64
    chroma blocks are not."""
    height = width = 128
    samp, coefs = _dc_only(sampling, height, width, 4)
    rng = np.random.default_rng(5)
    for c in coefs:
        flat = c.reshape(*c.shape[:2], 64)
        flat[..., reference.ZIGZAG[1:6]] = 6 * rng.choice([-1, 1], c.shape[:2] + (5,))
    f = _frame(coefs, samp, height, width)
    symbols = _holds_its_coefficients(f)
    chroma = 1 if sampling == "4:2:0" else 2
    assert [symbols[i] for i in (5, 7, 8, 9)] == [2, chroma, chroma, 2]
    _, got = _pillow(f.data)
    assert np.array_equal(got, reference.rgb(f.coefs, f.qtables, samp, height, width, "fancy"))


@pytest.mark.parametrize("change,why", [
    ({"header": "rfc2435"}, "RFC 2435"),
    ({"huffman_tables": "annex_k"}, "EOBRUN"),
    ({"scan_script": "progressive"}, "scan_script"),
])
def test_validate_refuses_what_the_encoder_does_not_write(change, why):
    c = cells.load("places365-256.b256")
    config = dict(c.config, scan_script="simple_progression", huffman_tables="optimal")
    drivers.validate(c.driver, config, c.traffic)
    with pytest.raises(ValueError, match=why):
        drivers.validate(c.driver, dict(config, **change), c.traffic)
    del config["scan_script"]
    with pytest.raises(ValueError, match="missing"):
        drivers.validate(c.driver, config, c.traffic)


def test_a_progressive_pool_holds_the_sequential_pools_images():
    """The loader's pool under ``simple_progression``: the images of the
    sequential pool of the same seed, in the same order, as SOF2 files."""
    c = cells.load("places365-256.b256")
    c.config.update(sizes=[[50, 37, 0.5], [93, 61, 0.5]], huffman_tables="optimal")
    c.traffic.update(batch=3, pool_batches=2, compare_per_batch=1)
    prog = copy.deepcopy(c.config)
    prog["scan_script"] = "simple_progression"
    drivers.validate(c.driver, prog, c.traffic)
    a = c.driver.make_pool(prog, c.traffic, SEEDS[1])
    b = c.driver.make_pool(c.config, c.traffic, SEEDS[1])
    assert [f.data for f in a] == [f.data for f in c.driver.make_pool(prog, c.traffic, SEEDS[1])]
    assert len(a) == 6
    for fa, fb in zip(a, b):
        assert fa.data[2:4] == b"\xff\xe0" and b"\xff\xc2" in fa.data and b"\xff\xc0" in fb.data
        assert (fa.height, fa.width) == (fb.height, fb.width)
        assert all(np.array_equal(x, y) for x, y in zip(fa.coefs, fb.coefs))


# sha256 of the concatenated bytes of each committed cell's pool, recorded
# before the progressive encoder was added: its refactoring of frames.py
# changes no byte.
POOL_SHA256 = {
    ("places365-256.b256", 1): "7b241ab431434232b38bf6726e2c739d99340a10781c523f729ecee1f8228080",
    ("places365-256.b256", 2**32 + 365):
        "45ac846bc02da15f7a898fcaaed7f84f2ce4836033afea3009a04eff2989e9e0",
    ("mjpeg-1080p.scan", 1): "74b2fc52eac90b0c2f955cd06f266b4835e9ac9730fb957bfaa109dc1bb94e92",
    ("mjpeg-1080p.scan", 2**32 + 365):
        "8a696c016a08513204fdae559ac22c50d92c8663d35c34e78822476bbf7a53ac",
}


@pytest.mark.parametrize("cell,seed", sorted(POOL_SHA256))
def test_the_committed_cells_pools_are_unchanged(cell, seed):
    c = cells.load(cell)
    h = hashlib.sha256()
    for f in c.driver.make_pool(c.config, c.traffic, seed):
        h.update(f.data)
    assert h.hexdigest() == POOL_SHA256[(cell, seed)]
