"""Exact-capacity geometry for the range exchange.

The range exchange's receive side uses pow2 x pow2 run geometry (a
leftover of the bitonic merge network this build used to have), but the per-(src,dst) segment mean is itself a power of
two whenever the batch is (production batches snap to pow2 flats), so ANY
headroom used to round the slot capacity up to the next power of two —
the old `next_pow2(capacity_factor * mean)` rule — made every receive-side
merge, count, and all_to_all process 2x n_local elements.

Instead each exchange cell carries `capacity = m + sc` contiguous elements
of the segment, where m = next_pow2(mean) holds the bulk and a small
spill lane sc >> fluctuation absorbs the hash-uniform overhang
(sigma ~ sqrt(n/S) keys). The exactness lives on the WIRE — the
all_to_all ships ~2x fewer bytes; the receive side sentinel-pads each
run back to 2m before the merge
(parallel/pipeline._range_exchange_merge).

Two 1x-plane receive formulations were also built and dropped: folding
the spill tails into a 1x main plane by lexicographic binary search +
scatter-add, and by one extra top-level merge level (two merge calls
materialize the plane twice). Neither has been measured on the H100.

The reference avoids the problem with exact receive preallocation
(src/kmerops.cpp:439-471) — possible there because MPI ranks exchange
byte counts first; XLA collectives need static shapes, so the exactness
moves into the static geometry + spill lane.
"""

from __future__ import annotations



def split_capacity(capacity: int) -> tuple[int, int]:
    """capacity -> (m, sc): m = largest power of two <= capacity.

    sc == 0 (capacity itself pow2) selects the legacy single-plane
    geometry — EXT mode and the overflow-retry doubling both preserve the
    invariant (m + sc doubles to 2m + 2sc with 2m still the largest pow2).
    """
    m = 1 << (int(capacity).bit_length() - 1)
    return m, capacity - m
