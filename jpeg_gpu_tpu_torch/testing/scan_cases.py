"""Table tensors that K3's symbol tables must cope with besides an
encoder's.  Used by the CPU tests of the tables' plain version and by the
checks of the kernel on the card.
"""

import numpy as np

from jpeg_gpu_tpu_torch.host.segments import _decode_tables, window_rows
from jpeg_gpu_tpu_torch.info import HuffmanSpec

# Codes of 11 bits in :func:`deep_code_tables`' AC table: two under each of
# DEEP_CODES / 2 prefixes of 10 bits.
DEEP_CODES = 200


def deep_code_tables(tables):
    """``tables`` (cbase, counts, symbols) with slot 4, the first AC table,
    replaced by a valid Huffman table of DEEP_CODES codes of 11 bits: long
    codes under more 10-bit prefixes than the first level has second-level
    tables for."""
    cbase, counts, symbols = (np.array(x) for x in tables)
    bits = np.zeros(16, np.uint8)
    bits[10] = DEEP_CODES
    cbase[4], counts[4], symbols[4] = _decode_tables(
        HuffmanSpec(1, bits, np.arange(1, DEEP_CODES + 1, dtype=np.uint8)))
    return cbase, counts, symbols


def random_tables(seed):
    """Random numbers in the table tensors' shapes: no Huffman tables."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-40, 70000, size=(8, 16)).astype(np.int32),
            rng.integers(-3, 40, size=(8, 17)).astype(np.int32),
            rng.integers(-2**31, 2**31, size=(8, 8, 128), dtype=np.int64).astype(np.int32))


def stream_windows(data: bytes, sb: int):
    """The window rows build_spec_scan_input cuts a destuffed stream into,
    for ``sb``-byte subsequences: (windows (BS, NWS, 8, 128) int32, spw)."""
    spw = sb // 4
    bs = max(1, -(-len(data) // (sb * 1024)))
    windows = window_rows(np.frombuffer(data, dtype=np.uint8), bs, spw, spw + 3)
    return np.ascontiguousarray(windows), spw


def dc_ramp_case(n_mcus: int = 1100, sb: int = 64):
    """A hand-made one-component stream without restart markers whose DC
    runs out of int16: every MCU is one block with DC difference +2047 and
    no AC coefficient.  DC table (slot 0): symbols 0 and 11, codes 00 and 01;
    AC table (slot 4): EOB, code 00.  An MCU is 01, eleven ones, 00: 15 bits.

    Returns (args, kwargs, dc): the positional arguments of
    ``decode_mcus_at_bitpos`` as numpy arrays (``n_bits`` an int), its
    ``spw`` keyword, and the DC values (n_mcus,) int16 it must give,
    2047 * (m + 1) wrapped as an int16 add wraps."""
    cbase = np.zeros((8, 16), np.int32)
    counts = np.zeros((8, 17), np.int32)
    counts[:, 16] = np.iinfo(np.int32).min
    symbols = np.full((8, 8, 128), (31 << 8) | (31 << 24), np.int32)
    two, one = np.zeros(16, np.uint8), np.zeros(16, np.uint8)
    two[1], one[1] = 2, 1
    cbase[0], counts[0], symbols[0] = _decode_tables(
        HuffmanSpec(0, two, np.array([0, 11], np.uint8)))
    cbase[4], counts[4], symbols[4] = _decode_tables(HuffmanSpec(1, one, np.array([0], np.uint8)))
    bits = ("01" + "1" * 11 + "00") * n_mcus
    bits += "1" * (-len(bits) % 8)
    data = int(bits, 2).to_bytes(len(bits) // 8, "big")
    windows, spw = stream_windows(data, sb)
    bitpos = (15 * np.arange(n_mcus)).astype(np.int32)
    maps = (np.zeros(1, np.int32), np.zeros(1, np.int32), np.full(1, 4, np.int32))
    dc = (2047 * (np.arange(n_mcus, dtype=np.int64) + 1)).astype(np.int16)
    return (windows, bitpos, len(data) * 8, *maps, cbase, counts, symbols), {"spw": spw}, dc
