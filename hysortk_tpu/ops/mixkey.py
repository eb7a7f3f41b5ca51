"""Invertible multiword key mixing: sort key == routing key.

The reference routes k-mers to owner tasks by hashing (minimizer hash %
tasks, src/kmerops.cpp:1044-1047) and then sorts the received k-mers — two
independent orders, which on a device would force two full sorts per shard (one to
group by destination, one to order received keys). Instead the sharded
pipeline sorts each shard's keys ONCE in a *mixed* key space:

  mixed = M(key), with M a bijection on the W-word key space whose top bits
  are uniformly distributed (full avalanche).

Then
  * destination = range of mixed[0] (a monotone function of the sort order),
    so one local sort simultaneously orders keys and groups destinations
    into contiguous segments — uniformly sized even on skewed genomes;
  * equal mixed keys <=> equal keys (bijectivity), so run-length counting in
    mixed space is exact;
  * the receiver gets S already-sorted runs to merge (a lax.sort
    re-sort of the concatenation; see PERF.md);
  * the compacted results are un-mixed (M^-1) on the host.

M is a cyclic Feistel-style network of murmur3 fmix32 steps
(w[i] = fmix32(w[i] + w[(i+1) % W] + C)), each step invertible, finished
with a constant XOR chosen so that the all-ones invalid-slot sentinel
(ops/sort.py) is a fixed point of M: M(F) = F. Since M is a bijection and F
is never a valid canonical key (see ops/sort.py sentinel rationale), no
valid key can mix to the sentinel — sentinel-marked arrays can be mixed
in place.

The same invertible-hash idea exists in the reference as wanghash64 +
inverse (src/hashfuncs.cpp), kept there for debugging; here it is the
load-bearing routing design.
"""

from __future__ import annotations

import functools

import numpy as np

_ROUNDS = 2
# Round constants: odd golden-ratio multiples (any fixed odd values work).
_RC = [0x9E3779B1 * (2 * i + 1) & 0xFFFFFFFF for i in range(16)]

_FULL = np.uint32(0xFFFFFFFF)


# --- numpy reference implementation (host side + inverse) -------------------


def _fmix32_np(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x = (x * np.uint32(0x85EBCA6B)).astype(np.uint32)
    x ^= x >> np.uint32(13)
    x = (x * np.uint32(0xC2B2AE35)).astype(np.uint32)
    x ^= x >> np.uint32(16)
    return x


_INV_C1 = np.uint32(pow(0x85EBCA6B, -1, 1 << 32))
_INV_C2 = np.uint32(pow(0xC2B2AE35, -1, 1 << 32))


def _fmix32_inv_np(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x = (x * _INV_C2).astype(np.uint32)
    x ^= (x >> np.uint32(13)) ^ (x >> np.uint32(26))
    x = (x * _INV_C1).astype(np.uint32)
    x ^= x >> np.uint32(16)
    return x


def _mix_core_np(words: list[np.ndarray]) -> list[np.ndarray]:
    w = [x.astype(np.uint32).copy() for x in words]
    W = len(w)
    for r in range(_ROUNDS):
        for i in range(W):
            c = np.uint32(_RC[r * W + i])
            if W == 1:
                w[0] = _fmix32_np(w[0] + c)
            else:
                w[i] = _fmix32_np(w[i] + w[(i + 1) % W] + c)
    return w


@functools.lru_cache(maxsize=None)
def _sentinel_fix(W: int) -> tuple[int, ...]:
    """XOR constants making the all-ones sentinel a fixed point of M."""
    mf = _mix_core_np([np.asarray([_FULL]) for _ in range(W)])
    return tuple(int(m[0] ^ _FULL) for m in mf)


def mix_keys_np(keys: np.ndarray) -> np.ndarray:
    """(M, W) uint32 canonical keys -> mixed keys (numpy)."""
    W = keys.shape[1]
    fix = _sentinel_fix(W)
    w = _mix_core_np([keys[:, i] for i in range(W)])
    return np.stack(
        [x ^ np.uint32(fix[i]) for i, x in enumerate(w)], axis=-1
    )


def unmix_keys_np(mixed: np.ndarray) -> np.ndarray:
    """(M, W) mixed keys -> original canonical keys (exact inverse)."""
    W = mixed.shape[1]
    fix = _sentinel_fix(W)
    w = [
        (mixed[:, i] ^ np.uint32(fix[i])).astype(np.uint32)
        for i in range(W)
    ]
    for r in range(_ROUNDS - 1, -1, -1):
        for i in range(W - 1, -1, -1):
            c = np.uint32(_RC[r * W + i])
            if W == 1:
                w[0] = (_fmix32_inv_np(w[0]) - c).astype(np.uint32)
            else:
                w[i] = (
                    _fmix32_inv_np(w[i]) - w[(i + 1) % W] - c
                ).astype(np.uint32)
    return np.stack(w, axis=-1)


# --- device implementation ---------------------------------------------------


def mix_keys(words):
    """List of W uint32 arrays -> mixed arrays (jax). Sentinel-invariant."""
    import jax.numpy as jnp

    from .hashes import fmix32

    W = len(words)
    fix = _sentinel_fix(W)
    w = [x.astype(jnp.uint32) for x in words]
    for r in range(_ROUNDS):
        for i in range(W):
            c = jnp.uint32(_RC[r * W + i])
            if W == 1:
                w[0] = fmix32(w[0] + c)
            else:
                w[i] = fmix32(w[i] + w[(i + 1) % W] + c)
    return [x ^ jnp.uint32(fix[i]) for i, x in enumerate(w)]


def range_destinations(mixed0, num_shards: int):
    """Destination shard of each mixed key: (mixed[0] * S) >> 32.

    Monotone in mixed[0] (so destinations are contiguous segments of the
    sorted order) and uniform for any S (multiply-shift range partition).
    Computed in u32 via a 16-bit-split mulhi (no u64 on device); requires
    num_shards <= 65536.
    """
    import jax.numpy as jnp

    assert num_shards <= 1 << 16, num_shards
    v = mixed0.astype(jnp.uint32)
    s = jnp.uint32(num_shards)
    a = (v >> jnp.uint32(16)) * s
    b = (v & jnp.uint32(0xFFFF)) * s
    return (a + (b >> jnp.uint32(16))) >> jnp.uint32(16)


def range_boundaries(num_shards: int) -> np.ndarray:
    """boundaries[d] = smallest mixed[0] owned by shard d (length S+1).

    ceil(d * 2^32 / S); searchsorted(sorted_mixed0, boundaries) yields the
    per-destination segment offsets of a sorted shard.
    """
    d = np.arange(num_shards + 1, dtype=np.uint64)
    return ((d << np.uint64(32)) + np.uint64(num_shards - 1)) // np.uint64(
        num_shards
    )
