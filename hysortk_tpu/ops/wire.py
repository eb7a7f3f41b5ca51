"""Device-side decode of the 2-bit packed read wire format.

The reference moves every base over the wire 2-bit packed inside supermers
(SupermerEncoder + copy_bits, src/kmerops.cpp:1096-1148) and re-extracts
k-mers receiver-side (GatheredSupermer stage 2, src/kmerops.cpp:484-521).
The device analogue of that receive-side parse: hosts feed devices
(packed uint32 words, read lengths) — ~2 bits/base + 4 B/read on the wire
instead of 9 bits/base for (int8 codes + bool mask) — and the device
reconstructs the flat (codes, valid) stream with dense bit math:

  * unpack: one shift/mask broadcast per 16-base word — no gathers;
  * validity: the last k-1 positions of each read (and everything past the
    last read) cannot start a k-mer — marked via a tiny scatter-add of
    +/-1 deltas at read boundaries (O(reads), not O(bases)) and one cumsum.

Packing lives host-side in io/supermer.py (pack_codes_2bit).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def unpack_codes(packed: jnp.ndarray, n: int) -> jnp.ndarray:
    """(n/16,) uint32 words -> (n,) int8 base codes.

    Word w holds bases 16w..16w+15, base b at bit shift 30 - 2*(b%16)
    (big-endian within the word, the reference's dnaseq bit order scaled
    from bytes to words — include/dnaseq.hpp:33-172).
    """
    shifts = jnp.uint32(30) - jnp.uint32(2) * jnp.arange(
        16, dtype=jnp.uint32
    )
    codes = (packed.astype(jnp.uint32)[:, None] >> shifts[None, :]) & jnp.uint32(3)
    return codes.reshape(-1)[:n].astype(jnp.int8)


def valid_from_lengths(
    lengths: jnp.ndarray, k: int, n: int
) -> jnp.ndarray:
    """(R,) int32 read lengths (zero-padded) -> (n,) k-mer-start validity.

    Reads are concatenated from flat position 0; position p starts a valid
    k-mer iff it lies at offset <= len-k inside its read. Equivalent to the
    host flattener (io/fasta.flatten_for_device) by construction.
    """
    lengths = lengths.astype(jnp.int32)
    ends = jnp.cumsum(lengths)
    starts = ends - lengths
    zone_start = jnp.maximum(ends - jnp.int32(k - 1), starts)
    total = ends[-1] if lengths.shape[0] else jnp.int32(0)

    delta = jnp.zeros(n + 1, jnp.int32)
    delta = delta.at[jnp.minimum(zone_start, n)].add(1)
    delta = delta.at[jnp.minimum(ends, n)].add(-1)
    delta = delta.at[jnp.minimum(total, n)].add(1)  # tail padding invalid
    invalid = jnp.cumsum(delta[:-1]) > 0
    return ~invalid


def decode_block(
    packed: jnp.ndarray, lengths: jnp.ndarray, k: int, n: int
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Wire block -> (codes int8 (n,), valid bool (n,))."""
    return unpack_codes(packed, n), valid_from_lengths(lengths, k, n)


def rid_pos_from_lengths(
    lengths: jnp.ndarray, n: int, rid_base: int
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(R,) read lengths -> per-position (read id, pos in read).

    EXTENSION payloads need not travel the wire at all: both are derivable
    from the lengths array with one boundary scatter + cumulative scans
    (rid = running count of read starts; pos = distance from the last
    start, via a cumulative max of start positions). Only meaningful where
    valid_from_lengths is True.
    """
    lengths = lengths.astype(jnp.int32)
    ends = jnp.cumsum(lengths)
    starts = ends - lengths
    start_marks = jnp.zeros(n + 1, jnp.int32)
    # EVERY read marks its start — including zero-length records, whose
    # marks stack on the next read's start so read ids keep counting ALL
    # records (matching the host flattener and the reference's global read
    # numbering). Tail-padding pseudo-reads mark at/after the real total,
    # where the valid mask is already False.
    start_marks = start_marks.at[jnp.minimum(starts, n)].add(1)
    rid = jnp.cumsum(start_marks[:-1]) - 1 + jnp.int32(rid_base)
    is_start = start_marks[:-1] > 0
    idx = jnp.arange(n, dtype=jnp.int32)
    last_start = jax.lax.cummax(jnp.where(is_start, idx, 0))
    pos = (idx - last_start).astype(jnp.uint32)
    return rid, pos


def decode_block_ext(
    packed: jnp.ndarray,
    lengths: jnp.ndarray,
    k: int,
    n: int,
    rid_base: int,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """EXT wire block -> (codes, valid, rid, pos)."""
    codes, valid = decode_block(packed, lengths, k, n)
    rid, pos = rid_pos_from_lengths(lengths, n, rid_base)
    return codes, valid, rid, pos


def fill_run_meta(
    lengths: jnp.ndarray,
    rid0: jnp.ndarray,
    pos0: jnp.ndarray,
    n: int,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Per-position (read id, pos in read) from per-RUN metadata.

    Runs (supermers) are concatenated from flat position 0 per `lengths`;
    run s starts at position pos0[s] of read rid0[s]. This is the decode of
    the reference's EXT supermer wire ({len, pos, rid} per supermer,
    include/kmer.hpp:348-360): piecewise-constant fill of arbitrary per-run
    values by a boundary DIFF scatter + cumsum — O(n) scans, no gathers.
    Only meaningful where valid_from_lengths is True.
    """
    lengths = lengths.astype(jnp.int32)
    ends = jnp.cumsum(lengths)
    starts = ends - lengths
    idx = jnp.arange(n, dtype=jnp.int32)

    def fill(vals):
        # cumsum of scattered value-diffs == forward fill of vals over
        # [start_s, start_{s+1}). Zero-length pad runs stack their diffs
        # on the next start; the telescoped sum stays correct.
        vals = vals.astype(jnp.int32)
        diffs = jnp.concatenate([vals[:1], vals[1:] - vals[:-1]])
        buf = jnp.zeros(n + 1, jnp.int32).at[
            jnp.minimum(starts, n)
        ].add(diffs)
        return jnp.cumsum(buf[:-1])

    rid = fill(rid0)
    pos = (fill(pos0.astype(jnp.int32) - starts) + idx).astype(jnp.uint32)
    return rid, pos
