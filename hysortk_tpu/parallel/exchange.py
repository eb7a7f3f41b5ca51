"""Key-space bucket exchange over the device mesh.

Device-collective replacement for the reference's two-stage batched MPI exchange
(TaskManager round loop + MPI_Ialltoall, src/kmerops.cpp:587-1007). The
reference's protocol exists to solve two problems MPI has and XLA doesn't:
unknown receive sizes (solved there by a count Alltoallv *before* payload,
kmerops.cpp:782) and bounded memory (fixed 80 kB rounds). Here:

  * counts still travel before/with the payload — a tiny `all_to_all` of the
    per-destination counts lets every receiver reconstruct validity masks
    without any host round-trip;
  * payload moves in ONE padded `all_to_all` per device batch: slot capacity
    is static (capacity_factor over the balanced mean), overflow is detected
    with a `pmax` flag (the analogue of the reference's completion flags,
    kmerops.cpp:984-990) and handled by the host re-running with a larger
    capacity — bounded memory comes from host-side device-batch streaming,
    not from chunked collectives.

Packing the send buffer is a sort-by-destination + dense gather: no serial
bucket walks, no scatter.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp

from ..ops import sort as sort_ops


def pack_by_destination(
    invalid: jnp.ndarray,
    dest: jnp.ndarray,
    words: Sequence[jnp.ndarray],
    payloads: Sequence[jnp.ndarray],
    num_shards: int,
    capacity: int,
):
    """Group valid entries by destination into a (num_shards, capacity, ...) buffer.

    Returns (send_words, send_payloads, send_counts, overflow):
      send_words:   list of W arrays (num_shards, capacity) uint32
      send_payloads: same shape per payload
      send_counts:  (num_shards,) int32 — entries destined to each shard
      overflow:     bool scalar — some destination exceeded `capacity`
    """
    dest_key = jnp.where(invalid == 0, dest.astype(jnp.uint32), jnp.uint32(num_shards))
    inv_s, sorted_rest, _ = sort_ops.sort_keys(
        invalid, [dest_key, *words, *payloads]
    )
    dest_s = sorted_rest[0]
    words_s = sorted_rest[1 : 1 + len(words)]
    payloads_s = sorted_rest[1 + len(words) :]

    # Destination segment offsets via searchsorted on the sorted dest column.
    queries = jnp.arange(num_shards + 1, dtype=jnp.uint32)
    offsets = jnp.searchsorted(dest_s, queries, side="left").astype(jnp.int32)
    counts = offsets[1:] - offsets[:-1]
    overflow = jnp.any(counts > capacity)

    slot_d = jax.lax.broadcasted_iota(jnp.int32, (num_shards, capacity), 0)
    slot_j = jax.lax.broadcasted_iota(jnp.int32, (num_shards, capacity), 1)
    src = jnp.minimum(offsets[:-1][:, None] + slot_j, dest_s.shape[0] - 1)
    send_words = [w[src] for w in words_s]
    send_payloads = [p[src] for p in payloads_s]
    # Validity is implied receiver-side by the exchanged counts; slots beyond
    # the count carry garbage that is never read.
    return send_words, send_payloads, counts, overflow


def pack_sorted_ranges(
    sorted_words: Sequence[jnp.ndarray],
    sorted_payloads: Sequence[jnp.ndarray],
    offsets: jnp.ndarray,
    num_shards: int,
    capacity: int,
):
    """Carve per-destination segments out of an already-sorted shard.

    Under range routing (ops/mixkey.py) the destination of a key is a
    monotone function of the sort order, so the local sort has ALREADY
    grouped destinations into contiguous segments; `offsets` (length S+1)
    are their boundaries. No destination sort is needed — packing is S
    dynamic slices of `capacity` contiguous elements each.

    Dynamic slices, not an (S, capacity) gather: the gather form lowers
    generically and moves every element through an index. Each array is
    padded by `capacity` tail elements so no slice start ever clamps
    (dynamic_slice clamps the START, which would shift — i.e. corrupt —
    the carved segment; slots past each row's count are masked or never
    read downstream, so the pad value itself is irrelevant).

    Returns (send_words, send_payloads, counts, overflow) like
    pack_by_destination.
    """
    counts = (offsets[1:] - offsets[:-1]).astype(jnp.int32)
    overflow = jnp.any(counts > capacity)
    starts = offsets[:-1]

    def carve(arr):
        # Dtype-safe all-ones pad (-1 cast): jnp.full with a uint32 literal
        # would raise at trace time for any future signed payload.
        ap = jnp.concatenate(
            [arr, jnp.full((capacity,), jnp.array(-1).astype(arr.dtype))]
        )
        rows = [
            jax.lax.dynamic_slice_in_dim(ap, starts[s], capacity)
            for s in range(num_shards)
        ]
        return jnp.stack(rows)

    send_words = [carve(w) for w in sorted_words]
    send_payloads = [carve(p) for p in sorted_payloads]
    return send_words, send_payloads, counts, overflow


def mask_invalid_slots(
    recv_words: Sequence[jnp.ndarray], recv_valid: jnp.ndarray
) -> list[jnp.ndarray]:
    """Overwrite slots beyond each row's count with the all-ones sentinel.

    Keeps every received row sorted ascending end to end (the garbage tail
    becomes a sentinel tail), which the run merge requires.
    """
    full = jnp.uint32(0xFFFFFFFF)
    return [jnp.where(recv_valid, w, full) for w in recv_words]


def all_to_all_exchange(
    send_words: Sequence[jnp.ndarray],
    send_payloads: Sequence[jnp.ndarray],
    send_counts: jnp.ndarray,
    axis_name: str,
):
    """Exchange (num_shards, capacity) blocks so block s comes from shard s.

    Returns (recv_words, recv_payloads, recv_counts, recv_valid_flat).
    """
    a2a = lambda x: jax.lax.all_to_all(
        x, axis_name, split_axis=0, concat_axis=0, tiled=True
    )
    recv_words = [a2a(w) for w in send_words]
    recv_payloads = [a2a(p) for p in send_payloads]
    recv_counts = a2a(send_counts)
    capacity = send_words[0].shape[1]
    slot_j = jax.lax.broadcasted_iota(
        jnp.int32, (recv_counts.shape[0], capacity), 1
    )
    recv_valid = slot_j < recv_counts[:, None]
    return recv_words, recv_payloads, recv_counts, recv_valid
