"""Table tensors that K3's symbol tables must cope with besides an
encoder's.  Used by the CPU tests of the tables' plain version and by the
checks of the kernel on the card.
"""

import numpy as np

from jpeg_gpu_tpu_torch.host.segments import _decode_tables
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
