"""Multiword key sort.

The reference sorts KmerSeedStruct arrays with PARADIS (in-place parallel MSD
radix, dependency/Paradis/paradissort.hpp:36-215) or RADULS (out-of-place
cache-aware MSD radix, dependency/Raduls/raduls.h), chosen at runtime by free
memory (src/kmerops.cpp:1344-1379). Here the sort is jax.lax.sort over the W
uint32 key words (lexicographic via num_keys), with any payloads carried as
extra operands; XLA picks the device implementation.

Invalid/padding slots are folded INTO the key as an all-ones sentinel rather
than carried as a separate leading sort operand: a valid canonical k-mer can
never be all-T (its reverse complement, all-A, is lexicographically smaller,
so GetRep would have chosen it — reference include/kmer.hpp:316-321), hence
the all-ones pattern in every word is unreachable and sorts strictly after
every real key. This removes one full operand stream from the sort.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp

_FULL = jnp.uint32(0xFFFFFFFF)


def apply_sentinel(
    invalid: jnp.ndarray, words: Sequence[jnp.ndarray]
) -> list[jnp.ndarray]:
    """Overwrite invalid slots with the unreachable all-ones key."""
    inv = invalid.astype(jnp.bool_) if invalid.dtype != jnp.bool_ else invalid
    return [jnp.where(inv, _FULL, w) for w in words]


def sentinel_valid(words: Sequence[jnp.ndarray]) -> jnp.ndarray:
    """Recover the validity mask after sorting sentinel-folded keys."""
    all_ones = jnp.ones(words[0].shape, dtype=jnp.bool_)
    for w in words:
        all_ones = all_ones & (w == _FULL)
    return ~all_ones


def sort_keys(
    invalid: jnp.ndarray,
    words: Sequence[jnp.ndarray],
    payloads: Sequence[jnp.ndarray] = (),
) -> tuple[jnp.ndarray, list[jnp.ndarray], list[jnp.ndarray]]:
    """Sort by key words lexicographically, invalid slots last, carrying payloads.

    Returns (sorted_invalid, sorted_words, sorted_payloads), where
    sorted_invalid is uint32 (0 = valid, 1 = invalid) for compatibility.
    """
    marked = apply_sentinel(invalid, words)
    return sort_marked(marked, payloads)


def sort_marked(
    marked: Sequence[jnp.ndarray],
    payloads: Sequence[jnp.ndarray] = (),
) -> tuple[jnp.ndarray, list[jnp.ndarray], list[jnp.ndarray]]:
    """Sort keys already carrying the all-ones invalid sentinel."""
    n_words = len(marked)
    out = jax.lax.sort((*marked, *payloads), num_keys=n_words, is_stable=False)
    sorted_words = list(out[:n_words])
    sorted_payloads = list(out[n_words:])
    inv_sorted = (~sentinel_valid(sorted_words)).astype(jnp.uint32)
    return inv_sorted, sorted_words, sorted_payloads
