"""Minimizer scan: per-k-mer destination buckets, fully vectorized.

Data-parallel redesign of the reference's sequential monotonic-deque sliding
window minimum (reference: Minimizer_Deque, src/kmerops.cpp:1058-1073, and
FindKmerDestinationsParallel, src/kmerops.cpp:1010-1041). A deque is
data-dependent control flow, hostile to XLA; instead the window minimum over
the k-m+1 canonical m-mer hashes inside each k-mer is computed with
log2(window) shifted-min doubling steps (the standard parallel
sliding-window-min construction; cf. "Parallel approach to sliding window
sums", arXiv:1811.10074).

Destinations only affect *distribution*, not counted output, so the hash need
not equal the reference's murmur64 (see ops/hashes.py).
"""

from __future__ import annotations

import jax.numpy as jnp

from . import hashes, kmer as kmer_ops


def mmer_hashes(codes: jnp.ndarray, m: int) -> jnp.ndarray:
    """(N,) uint32 hash of the canonical m-mer starting at each position.

    Positions whose m-mer window crosses a read boundary produce garbage, but
    such positions are never inside the minimizer window of a *valid* k-mer
    (a valid k-mer at i spans m-mer starts i..i+k-m, all inside the read).
    """
    words = kmer_ops.canonical_words(codes, m)
    return hashes.mix_words(words)


def sliding_window_min(x: jnp.ndarray, window: int) -> jnp.ndarray:
    """out[i] = min(x[i], ..., x[i + window - 1]) via doubling min-rolls."""
    cur = 1
    out = x
    while cur < window:
        step = min(cur, window - cur)
        out = jnp.minimum(out, jnp.roll(out, -step))
        cur += step
    return out


def kmer_destinations(
    codes: jnp.ndarray, k: int, m: int, num_buckets: int
) -> jnp.ndarray:
    """(N,) int32 destination bucket of the k-mer starting at each position.

    dest = (min canonical-m-mer hash over the k-mer's window) % num_buckets,
    the same ownership rule as the reference (hash % tot_tasks,
    src/kmerops.cpp:1044-1047) with a different (32-bit) hash.
    """
    mh = mmer_hashes(codes, m)
    minh = sliding_window_min(mh, k - m + 1)
    return (minh % jnp.uint32(num_buckets)).astype(jnp.int32)
