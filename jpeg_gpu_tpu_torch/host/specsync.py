"""Speculative self-synchronizing parallel index scan (DRI-less streams).

The one serial bottleneck left in the DRI-less path is the host index
scan: a single dependency chain that Huffman-walks the whole entropy
stream to find pseudo-segment bit offsets and DC predictor bases
(entropy_native.index_scan, 8.3 ms/frame at 1080p).  This module is the
parallel replacement, PROTOTYPED IN NUMPY in exactly the lockstep form
the TPU kernel would take (vectorized over subsequences = lanes, one
symbol per step, branch-free masked updates, the kernel's own canonical
rank-decode tables) so each piece ports 1:1 to Pallas.

Algorithm -- a Jacobi fixed-point iteration on subsequence entry states:

* Split the destuffed stream into S fixed-size subsequences (SB bytes).
* A decoder state is (bit position, block-in-MCU phase c, zigzag k,
  at_dc) -- everything the serial decode carries across a subsequence
  boundary except the DC predictors (which are deltas, see below).
* Round 0 guesses every subsequence's entry state: its first bit,
  phase = MCU start.  Each round decodes every subsequence from its
  current entry state to its first token boundary past the subsequence
  end (the exit state), IN PARALLEL; round r+1's entry for subsequence
  s+1 is round r's exit of s.  Entry 0 is pinned to the true scan start.
* At the fixed point (entries stop changing) the chain IS the serial
  decode, by induction from entry 0 -- self-synchronization of Huffman
  codes only bounds HOW FAST the fixed point is reached (measured ~3
  rounds; a wrong entry merges with the true token alignment within a
  few symbols), never the result.  Convergence is detected, not assumed.
* DC predictors ride along as per-subsequence DIFF SUMS (decoded DC
  diffs per component), turned absolute by one exclusive prefix sum --
  the same trick the restart-parallel kernel uses for coefficients.
* Each subsequence records the MCU starts inside its token span; the
  spans partition the token stream exactly, so concatenating records
  yields every MCU's bit offset + entering DC predictor: the
  index_scan contract, bit-identical (asserted in tests against the
  native scan).

Device mapping (the Pallas port this prototype de-risks): subsequences
map to (sublane, lane) slots exactly like restart segments; each round
is one kernel invocation (same refill/rank-decode/consume inner loop as
ops/entropy_device.py, ~8*SB/2 worst-case iterations); entries shift by
one subsequence between rounds (one XLA slice); the host loop runs a
STATIC number of rounds and falls back to the native scan when the
convergence flag (one all-equal reduction) is false.  Phase costs: the
per-lane table slot makes the rank constants per-lane selects (8-way)
instead of SMEM scalars -- the one real cost the lockstep design avoids,
and why this stays a boundary finder rather than replacing the
coefficient kernel.

Behavior spec: the serial scan it replaces is xjpeg_host.cpp's
xjpeg_index_scan (itself from-scratch; the reference never parallelized
entropy decode at all -- xjpeg.c:449-632 is its serial CPU walk).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from jpeg_gpu_tpu_torch.host.parser import ParsedJpeg
from jpeg_gpu_tpu_torch.host.segments import _step_maps, _table_tensors


@dataclasses.dataclass
class SpecSyncResult:
    """Converged parallel index scan of a DRI-less stream."""

    bitpos: np.ndarray        # (n_mcus,) int64: destuffed bit offset of MCU m
    dc_base: np.ndarray       # (n_mcus, ncomp) int32: DC predictors entering m
    end_bit: int              # total scan bits (token-boundary end)
    rounds: int               # rounds until the entry fixed point
    converged: bool           # False -> caller must fall back to the scan
    n_subseq: int
    subseq_bytes: int


def destuff(parsed: ParsedJpeg) -> np.ndarray:
    """Destuffed entropy bytes of a single-segment (DRI-less) stream."""
    if len(parsed.segments) != 1:
        raise ValueError("specsync is for single-segment (no-DRI) streams")
    s0, e0 = (int(x) for x in parsed.segments[0])
    arr = np.frombuffer(parsed.data, dtype=np.uint8)[s0:e0]
    # A stuffed zero is a 0x00 directly after 0xFF inside the segment.
    stuffed = np.zeros(arr.shape, dtype=bool)
    stuffed[1:] = (arr[1:] == 0) & (arr[:-1] == 0xFF)
    return arr[~stuffed]


def _flat_entries(symbols: np.ndarray) -> np.ndarray:
    """(8, 8, 128) packed table tiles -> (8, 256) uint32 (sym | len<<8)."""
    row = symbols[:, 0, :].astype(np.int64).astype(np.uint32)  # (8, 128)
    out = np.empty((symbols.shape[0], 256), dtype=np.uint32)
    out[:, 0::2] = row & 0xFFFF
    out[:, 1::2] = row >> 16
    return out


class _SpecDecoder:
    """Lockstep symbol decoder over all subsequences (the kernel body).

    Every per-step operation is a masked vector update over the S lanes
    -- the exact shape of the Pallas port.  numpy is the reference
    semantics; no Python-level per-lane branching anywhere.
    """

    def __init__(self, parsed: ParsedJpeg, subseq_bytes: int):
        header = parsed.header
        scan = header.scan
        assert scan is not None
        self.header = header
        data = destuff(parsed)
        self.n_bytes = data.size
        # Padding: decodes may read ~46 bits past a subsequence end, and
        # the tail lanes run into padding; 0xFF bytes mimic the kernel's
        # pad rows (invalid codes, deterministic consumption).
        self.data = np.concatenate(
            [data, np.full(8, 0xFF, dtype=np.uint8)]
        ).astype(np.uint64)
        self.sb = subseq_bytes
        self.n_sub = max(1, -(-self.n_bytes // subseq_bytes))
        comp_steps, dc_steps, ac_steps, bpm = _step_maps(header, scan, 1)
        self.bpm = bpm
        self.comp_of_c = np.asarray(comp_steps, dtype=np.int32)
        self.dc_slot_of_c = np.asarray(dc_steps, dtype=np.int32)
        self.ac_slot_of_c = np.asarray(ac_steps, dtype=np.int32)
        cbase, counts, symbols = _table_tensors(header)
        self.cbase = cbase.astype(np.int64)            # (8, 16)
        self.counts = counts.astype(np.int64)          # (8, 17)
        self.entries = _flat_entries(symbols)          # (8, 256)
        self.ncomp = len(header.components)

    # -- bit window ---------------------------------------------------

    def _peek32(self, p: np.ndarray) -> np.ndarray:
        """Next 32 bits at absolute bit position p (MSB-first), uint32."""
        byte = (p >> 3).astype(np.int64)
        sh = (p & 7).astype(np.uint64)
        idx = byte[:, None] + np.arange(5, dtype=np.int64)[None, :]
        idx = np.minimum(idx, self.data.size - 1)
        b = self.data[idx]  # (S, 5) uint64
        v = (
            (b[:, 0] << 32) | (b[:, 1] << 24) | (b[:, 2] << 16)
            | (b[:, 3] << 8) | b[:, 4]
        )
        return ((v >> (np.uint64(8) - sh)) & np.uint64(0xFFFFFFFF)).astype(
            np.uint32
        )

    # -- canonical rank decode (mirrors entropy_device.decode_symbol) --

    def _decode_symbol(
        self, w: np.ndarray, slot: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(window, per-lane slot) -> (sym, len); len==17 marks invalid."""
        w64 = w.astype(np.int64)
        rank = np.zeros(w.shape, dtype=np.int64)
        for length in range(1, 17):
            top = w64 >> (32 - length)
            cb = self.cbase[slot, length - 1]
            ct = self.counts[slot, length - 1]
            rank += np.clip(top - cb, 0, ct)
        idx = np.clip(rank - 1, 0, 255)
        ent = self.entries[slot, idx]
        # Invalid-window check, exactly the kernel's signed compare.
        lim = self.counts[slot, 16].astype(np.int64)
        wi = (w ^ np.uint32(0x80000000)).astype(np.int64)
        wi = np.where(wi >= 2**31, wi - 2**32, wi)
        bad = wi >= lim
        ln = np.where(bad, 17, (ent >> 8) & 0xFF).astype(np.int64)
        sym = np.where(bad | (ln > 16), 0, ent & 0xFF).astype(np.int64)
        ln = np.where(ln > 16, 17, ln)
        return sym, ln

    @staticmethod
    def _extend(w: np.ndarray, ln: np.ndarray, size: np.ndarray) -> np.ndarray:
        """Amplitude bits at [ln, ln+size) of the window, EXTENDed."""
        w64 = w.astype(np.uint64)
        raw = ((w64 << ln.astype(np.uint64)) & np.uint64(0xFFFFFFFF)) >> (
            np.uint64(32) - size.astype(np.uint64)
        )
        raw = np.where(size > 0, raw, 0).astype(np.int64)
        half = np.int64(1) << np.maximum(size - 1, 0)
        full = np.int64(1) << np.minimum(size, 30)
        return np.where((size > 0) & (raw < half), raw - full + 1, raw)

    # -- one round ----------------------------------------------------

    def run_round(
        self, entry: Tuple[np.ndarray, ...], max_mcu_rec: int
    ) -> Tuple[Tuple[np.ndarray, ...], dict]:
        """Decode every subsequence from its entry state to its exit.

        entry/exit: (p, c, at_dc, k) int64/int32/bool/int32 arrays (S,).
        Records MCU starts inside each lane's token span.
        """
        p, c, at_dc, k = (a.copy() for a in entry)
        S = self.n_sub
        end = (np.arange(S, dtype=np.int64) + 1) * (self.sb * 8)
        end = np.minimum(end, np.int64(self.n_bytes * 8))
        dcsum = np.zeros((S, self.ncomp), dtype=np.int64)
        rec_pos = np.full((S, max_mcu_rec), -1, dtype=np.int64)
        rec_dc = np.zeros((S, max_mcu_rec, self.ncomp), dtype=np.int64)
        rec_n = np.zeros(S, dtype=np.int64)
        overflow = False
        # Worst case: every token is one bit of code (rank decode always
        # consumes >= 1) -- bound the loop and detect pathologies.
        for _ in range(self.sb * 8 + 2):
            act = p < end
            if not act.any():
                break
            # MCU-start record (token boundary, at_dc, phase 0).
            is_mcu = act & at_dc & (c == 0)
            if is_mcu.any():
                slot_full = rec_n >= max_mcu_rec
                if (is_mcu & slot_full).any():
                    overflow = True
                    break
                li = np.nonzero(is_mcu)[0]
                rec_pos[li, rec_n[li]] = p[li]
                rec_dc[li, rec_n[li]] = dcsum[li]
                rec_n[li] += 1
            w = self._peek32(p)
            slot = np.where(
                at_dc, self.dc_slot_of_c[c], self.ac_slot_of_c[c]
            )
            sym, ln = self._decode_symbol(w, slot)
            # DC step: size = sym (<=15 valid); block continues into AC.
            dc_size = np.minimum(sym, 15)
            dc_diff = self._extend(w, ln, dc_size)
            # AC step: run/size split; EOB (0x00) or k past 63 ends the
            # block; invalid codes decode as EOB consuming 17 bits --
            # any deterministic >=1-bit rule works off the true path.
            run = sym >> 4
            ac_size = sym & 15
            ac_val = self._extend(w, ln, ac_size)  # noqa: F841 (sync pass)
            newk = k + run + 1
            eob = sym == 0
            blk_end = ~at_dc & (eob | (newk > 63) | (newk == 63))
            consume = np.where(at_dc, ln + dc_size, ln + ac_size)
            p = np.where(act, p + consume, p)
            comp = self.comp_of_c[c]
            add = np.where(act & at_dc, dc_diff, 0)
            np.add.at(dcsum, (np.arange(S), comp), add)
            k = np.where(act & at_dc, 0, np.where(act, np.minimum(newk, 63), k))
            new_c = np.where(blk_end, (c + 1) % self.bpm, c)
            c = np.where(act, new_c, c)
            at_dc = np.where(act, np.where(at_dc, False, blk_end), at_dc)
        else:
            overflow = True
        recs = {
            "pos": rec_pos, "dc": rec_dc, "n": rec_n,
            "dcsum": dcsum, "overflow": overflow,
        }
        return (p, c, at_dc, k), recs


def spec_index_scan(
    parsed: ParsedJpeg,
    subseq_bytes: int = 32,
    max_rounds: int = 16,
) -> Optional[SpecSyncResult]:
    """Parallel index scan by speculative decode + fixed-point sync.

    Returns None when the entry states did not converge within
    ``max_rounds`` (caller falls back to the serial native scan); a
    converged result is EXACTLY the serial scan's output by construction.
    """
    dec = _SpecDecoder(parsed, subseq_bytes)
    header = parsed.header
    S = dec.n_sub
    # An MCU costs at least bpm blocks x (1-bit DC + 1-bit EOB) -- bound
    # records per subsequence by that structural minimum.
    max_rec = max(2, subseq_bytes * 8 // max(2 * dec.bpm, 1) + 2)
    starts = np.arange(S, dtype=np.int64) * (subseq_bytes * 8)
    entry = (
        starts.copy(),
        np.zeros(S, dtype=np.int64),
        np.ones(S, dtype=bool),
        np.zeros(S, dtype=np.int64),
    )
    rounds = 0
    recs = None
    for rounds in range(1, max_rounds + 1):
        exit_state, recs = dec.run_round(entry, max_rec)
        # k is dead state at a DC boundary (the next DC step resets it):
        # normalize so irrelevant differences don't delay the fixed point.
        exit_state = exit_state[:3] + (
            np.where(exit_state[2], 0, exit_state[3]),
        )
        if recs["overflow"]:
            return None
        new_entry = tuple(
            np.concatenate([a[:1], x[:-1]])
            for a, x in zip(entry, exit_state)
        )
        if all(np.array_equal(a, b) for a, b in zip(entry, new_entry)):
            break
        entry = new_entry
    else:
        return None

    # Stitch: exclusive prefix sums turn per-lane deltas absolute.
    n = recs["n"]
    first_mcu = np.concatenate([[0], np.cumsum(n)[:-1]])
    lane_dc0 = np.concatenate(
        [np.zeros((1, dec.ncomp), np.int64), np.cumsum(recs["dcsum"], 0)[:-1]]
    )
    total = int(n.sum())
    bitpos = np.zeros(total, dtype=np.int64)
    dc_base = np.zeros((total, dec.ncomp), dtype=np.int64)
    li, si = np.nonzero(recs["pos"] >= 0)
    gidx = first_mcu[li] + si
    bitpos[gidx] = recs["pos"][li, si]
    dc_base[gidx] = lane_dc0[li] + recs["dc"][li, si]
    n_mcus = header.n_mcus
    if total < n_mcus:
        return None  # malformed stream: fewer MCUs than the header says
    # end_bit: the token boundary after the last real MCU = entry of the
    # first padding record, or the final exit position for the tail lane.
    if total > n_mcus:
        end_bit = int(bitpos[n_mcus])
    else:
        end_bit = int(exit_state[0][-1])
    return SpecSyncResult(
        bitpos=bitpos[:n_mcus],
        dc_base=dc_base[:n_mcus].astype(np.int32),
        end_bit=end_bit,
        rounds=rounds,
        converged=True,
        n_subseq=S,
        subseq_bytes=subseq_bytes,
    )
