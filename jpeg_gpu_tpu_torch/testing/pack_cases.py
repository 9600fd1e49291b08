"""Hand-made PACK streams that cover the corners of the format.

Each case is (u16 entries of lane 0, blocks T, words per row NW); the other
lanes of the (1, NW, 8, 128) stream tensor are empty.  :func:`walk` is a
scalar oracle of the format's rules.  Used by the CPU tests of K4's plain
version and by the checks of the kernel on the card.
"""

import numpy as np

from jpeg_gpu_tpu_torch.ops.zigzag import ZIGZAG


def stream_words(entries, nw):
    """u16 entries of lane 0 -> (1, nw, 8, 128) int32 streams (other lanes 0)."""
    e = list(entries) + [0] * (2 * nw - len(entries))
    assert len(e) == 2 * nw
    w = np.zeros((1, nw, 1024), dtype=np.uint32)
    w[0, :, 0] = [(e[2 * i] << 16) | e[2 * i + 1] for i in range(nw)]
    return w.view(np.int32).reshape(1, nw, 8, 128)


def walk(entries, t):
    """Scalar oracle: the format's rules on a Python list of u16 entries;
    reads past the list give 0.  Returns (t, 64) natural-order values."""
    def sign12(v):
        return v - 0x1000 if v >= 0x800 else v

    out = np.zeros((t, 64), dtype=np.int16)
    pos = 0

    def nxt():
        nonlocal pos
        e = entries[pos] if pos < len(entries) else 0
        pos += 1
        return e

    for b in range(t):
        out[b, 0] = sign12(nxt() & 0xFFF)
        k = 0
        while k < 63:
            e = nxt()
            if e == 0:
                break
            k += (e >> 12) + 1
            if k > 63:
                break
            out[b, ZIGZAG[k]] = sign12(e & 0xFFF)
    return out


HANDMADE = {
    # Block 0: DC -5, a run that lands past position 63 (writes nothing and
    # ends the block without an end-of-block entry).  Block 1 follows at once.
    "run_past_63": ([0xFFB, (14 << 12) | 7, (15 << 12) | 3, (15 << 12) | 9,
                     (10 << 12) | 1, (15 << 12) | 2,
                     0x011, (0 << 12) | 0xFFF, 0x0000], 2, 6),
    # Block 0: 63 AC values with run 0 fill the block, no end-of-block entry;
    # block 1's DC comes right after.
    "full_block_no_eob": ([0x7FF] + [(0 << 12) | (i + 1) for i in range(63)]
                          + [0x800, (2 << 12) | 0x801, 0x0000], 2, 34),
    # The row's last entry sits in the low half of the last word; the next
    # block reads past the row: DC 0 and end of block.
    "last_entry_in_last_word": ([0x123, (3 << 12) | 0x0F0, (15 << 12) | 0x005,
                                 0x0000, 0x002, (1 << 12) | 0x3], 3, 3),
    # An entry with run bits but value 0 stores 0 and still advances; an
    # all-zero entry ends the block whatever its position.
    "zero_value_entry": ([0x001, (2 << 12) | 0x000, (0 << 12) | 0x004, 0x0000,
                          0x000, 0x0000], 2, 3),
}


def lanes_words(rows, nw):
    """{lane: u16 entries} -> (1, nw, 8, 128) int32 streams, every other
    lane empty; lanes of different lengths share one tensor."""
    w = np.zeros((1, nw, 1024), dtype=np.uint32)
    for lane, entries in rows.items():
        w[0, :, lane] = stream_words(entries, nw).reshape(nw, 1024)[:, 0].view(np.uint32)
    return w.view(np.int32).reshape(1, nw, 8, 128)


def random_entries(rng, n):
    """Entries no encoder would write: any run, zero values, end entries
    and full blocks at random places."""
    e = rng.integers(0, 1 << 16, size=n)
    e[rng.random(n) < 0.15] = 0                     # end of block
    short = rng.random(n) < 0.5
    e[short] &= 0x1FFF                              # runs of 0 or 1
    return [int(x) for x in e]
