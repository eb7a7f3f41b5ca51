"""Run-length counting of sorted keys + [L, U] frequency filter.

Data-parallel redesign of the reference's linear count scan
(count_sorted_kmers, src/kmerops.cpp:1410-1479): instead of a sequential
run-length encoder, run extents are computed densely with prefix/suffix scans:

  head[i]   = first position of a run of equal keys
  next head = suffix-min over (head ? index : N) -> run length by subtraction

No scatter, no data-dependent loops; everything is (N,)-shaped dense math that
XLA fuses around the sort.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp


def run_length_count(
    sorted_valid: jnp.ndarray, sorted_words: Sequence[jnp.ndarray]
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Given validity-first sorted keys, return (head, count).

    head: bool (N,) — True at the first slot of each distinct valid key.
    count: int32 (N,) — at head slots, the number of equal keys; else 0.
    """
    n = sorted_valid.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    neq = jnp.zeros(n, dtype=jnp.bool_)
    for w in sorted_words:
        neq = neq | (w != jnp.roll(w, 1))
    neq = neq.at[0].set(True)
    head = sorted_valid & neq

    nvalid = jnp.sum(sorted_valid.astype(jnp.int32))
    head_pos = jnp.where(head, idx, n)
    # next_head[i] = min over j >= i+1 of head_pos[j]
    suffix_min = jax.lax.cummin(head_pos, axis=0, reverse=True)
    next_head = jnp.concatenate(
        [suffix_min[1:], jnp.full((1,), n, dtype=jnp.int32)]
    )
    run_end = jnp.minimum(next_head, nvalid)
    count = jnp.where(head, run_end - idx, 0)
    return head, count


def run_length_sum(
    sorted_valid: jnp.ndarray,
    sorted_words: Sequence[jnp.ndarray],
    weights: jnp.ndarray,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Like run_length_count but each slot contributes `weights[i]` to its run.

    Used by the combiner path (pre-aggregated (key, count) pairs arriving from
    the exchange — the analogue of the reference's GatheredKmerList merge,
    src/kmerops.cpp:546-581). With weights == valid this reduces to
    run_length_count.
    """
    n = sorted_valid.shape[0]
    neq = jnp.zeros(n, dtype=jnp.bool_)
    for w in sorted_words:
        neq = neq | (w != jnp.roll(w, 1))
    neq = neq.at[0].set(True)
    head = sorted_valid & neq

    w32 = jnp.where(sorted_valid, weights.astype(jnp.int32), 0)
    prefix = jnp.cumsum(w32)  # inclusive
    # Run sum at a head i = prefix[last slot of i's run] - prefix[i] + w[i].
    # The last slot of each run is the position just before the next head
    # (or n-1); invalid tail slots weigh 0, so letting the final run extend
    # into the sentinel tail changes nothing. prefix is NONDECREASING, so a
    # reverse cummin over (pre-head ? prefix : INT_MAX) propagates each
    # run's closing prefix back to every slot of the run — no gather.
    pre_head = jnp.concatenate(
        [head[1:], jnp.ones((1,), dtype=jnp.bool_)]
    )
    closing = jnp.where(pre_head, prefix, jnp.int32(2**31 - 1))
    end_prefix = jax.lax.cummin(closing, axis=0, reverse=True)
    count = jnp.where(head, end_prefix - prefix + w32, 0)
    return head, count


def frequency_filter(
    head: jnp.ndarray, count: jnp.ndarray, lower: int, upper: int
) -> jnp.ndarray:
    """keep[i] — head slots whose run count is within [lower, upper].

    Mirrors the reference's [L, U] filter (src/kmerops.cpp:1430-1460).
    """
    return head & (count >= lower) & (count <= upper)


def chunked_bincount(
    values: jnp.ndarray,
    valid: jnp.ndarray,
    num_bins: int,
    chunk: int = 8192,
) -> jnp.ndarray:
    """bincount of `values` (masked by `valid`) with bounded memory.

    A naive one-hot reduction materializes an (N, num_bins) intermediate —
    a 2^26 x 65536 boolean for a large `upper` — so the one-hot is built one
    `chunk` at a time under `lax.scan` with a (num_bins,) accumulator. The
    reference's histogram is likewise a linear pass (src/hysortk.cpp:98-136).
    """
    n = values.shape[0]
    chunk = min(chunk, max(n, 1))
    pad = -n % chunk
    if pad:
        values = jnp.concatenate([values, jnp.zeros(pad, values.dtype)])
        valid = jnp.concatenate([valid, jnp.zeros(pad, dtype=valid.dtype)])
    v = values.astype(jnp.int32).reshape(-1, chunk)
    m = valid.astype(jnp.bool_).reshape(-1, chunk)
    bins = jnp.arange(num_bins, dtype=jnp.int32)

    def step(acc, vm):
        vals, mask = vm
        onehot = (vals[:, None] == bins[None, :]) & mask[:, None]
        return acc + jnp.sum(onehot.astype(jnp.int32), axis=0), None

    acc0 = jnp.zeros(num_bins, dtype=jnp.int32)
    acc, _ = jax.lax.scan(step, acc0, (v, m))
    return acc


def histogram(
    keep: jnp.ndarray, count: jnp.ndarray, upper: int
) -> jnp.ndarray:
    """hist[c] = number of kept k-mers with frequency c, c in [0, upper].

    Matches print_kmer_histogram (src/hysortk.cpp:98-136), which histograms the
    *filtered* list, so counts never exceed `upper`. Memory-bounded even at
    the config envelope's upper=65535 (chunked scan, no (N, upper) one-hot).
    """
    return chunked_bincount(count, keep, upper + 1)
