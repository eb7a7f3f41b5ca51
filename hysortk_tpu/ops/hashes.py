"""Device-side 32-bit hash mixers.

The reference hashes minimizers/k-mers with MurmurHash3 x64-128
(reference: include/hashfuncs.hpp:9-16, src/hashfuncs.cpp:42-252). Hashes only
drive *distribution* (bucket ownership), never the counted output, so this
build is free to use 32-bit mixers on the uint32 key words instead of
64-bit multiplies. We use the murmur3 fmix32 finalizer as the mixing
primitive, combined across key words with the boost-style hash_combine round.
"""

from __future__ import annotations

import jax.numpy as jnp

_U32 = jnp.uint32


def fmix32(h: jnp.ndarray) -> jnp.ndarray:
    """murmur3 32-bit finalizer: full-avalanche bijective mixer."""
    h = h.astype(_U32)
    h = h ^ (h >> 16)
    h = h * _U32(0x85EBCA6B)
    h = h ^ (h >> 13)
    h = h * _U32(0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def mix_words(words: list[jnp.ndarray], seed: int = 313) -> jnp.ndarray:
    """Combine W uint32 words into one well-mixed uint32 hash.

    seed 313 kept as a nod to the reference's murmur seed
    (reference: src/hashfuncs.cpp murmurhash3 wrappers).
    """
    h = jnp.full(words[0].shape, _U32(seed & 0xFFFFFFFF))
    for w in words:
        h = h ^ fmix32(w.astype(_U32))
        h = h * _U32(0x9E3779B1) + _U32(0xE6546B64)
    return fmix32(h)


# ---------------------------------------------------------------------------
# Host-side (numpy) hash parity with the reference's hashfuncs
# (include/hashfuncs.hpp:9-16, src/hashfuncs.cpp:42-252): murmur3 x64
# finalizer-based 64-bit hash and the Wang 64-bit invertible hash + inverse.
# Used for reproducibility tooling and tests; device routing uses the 32-bit
# mixers above (hashes only steer distribution, never counted output).
# ---------------------------------------------------------------------------

import numpy as np

_M64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def murmurhash3_64(data: bytes, seed: int = 313) -> int:
    """MurmurHash3 x64-128 of `data`, first 64 bits — matches the reference's
    murmurhash3_64 wrapper (src/hashfuncs.cpp)."""
    c1 = 0x87C37B91114253D5
    c2 = 0x4CF5AD432745937F
    mask = (1 << 64) - 1

    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & mask

    def fmix(kx):
        kx ^= kx >> 33
        kx = (kx * 0xFF51AFD7ED558CCD) & mask
        kx ^= kx >> 33
        kx = (kx * 0xC4CEB9FE1A85EC53) & mask
        kx ^= kx >> 33
        return kx

    length = len(data)
    h1 = h2 = seed & mask
    nblocks = length // 16
    for i in range(nblocks):
        k1 = int.from_bytes(data[i * 16 : i * 16 + 8], "little")
        k2 = int.from_bytes(data[i * 16 + 8 : i * 16 + 16], "little")
        k1 = rotl((k1 * c1) & mask, 31)
        h1 ^= (k1 * c2) & mask
        h1 = rotl(h1, 27)
        h1 = (h1 + h2) & mask
        h1 = (h1 * 5 + 0x52DCE729) & mask
        k2 = rotl((k2 * c2) & mask, 33)
        h2 ^= (k2 * c1) & mask
        h2 = rotl(h2, 31)
        h2 = (h2 + h1) & mask
        h2 = (h2 * 5 + 0x38495AB5) & mask

    tail = data[nblocks * 16 :]
    k1 = k2 = 0
    if len(tail) > 8:
        k2 = int.from_bytes(tail[8:].ljust(8, b"\0"), "little")
        k2 = rotl((k2 * c2) & mask, 33)
        h2 ^= (k2 * c1) & mask
    if len(tail) > 0:
        k1 = int.from_bytes(tail[:8].ljust(8, b"\0"), "little")
        k1 = rotl((k1 * c1) & mask, 31)
        h1 ^= (k1 * c2) & mask

    h1 ^= length
    h2 ^= length
    h1 = (h1 + h2) & mask
    h2 = (h2 + h1) & mask
    h1 = fmix(h1)
    h2 = fmix(h2)
    h1 = (h1 + h2) & mask
    return h1


def wanghash64(key: int) -> int:
    """Wang's 64-bit invertible integer hash (reference src/hashfuncs.cpp)."""
    mask = (1 << 64) - 1
    key = (~key + (key << 21)) & mask
    key = key ^ (key >> 24)
    key = (key + (key << 3) + (key << 8)) & mask
    key = key ^ (key >> 14)
    key = (key + (key << 2) + (key << 4)) & mask
    key = key ^ (key >> 28)
    key = (key + (key << 31)) & mask
    return key


def wanghash64_inv(key: int) -> int:
    """Exact inverse of wanghash64 (reference keeps one for debugging)."""
    mask = (1 << 64) - 1
    # Invert key = key + (key << 31)  (i.e. key * (1 + 2^31))
    tmp = (key * pow(1 + (1 << 31), -1, 1 << 64)) & mask
    key = tmp
    # Invert key ^= key >> 28
    key = key ^ (key >> 28) ^ (key >> 56)
    # Invert key = key * (1 + 4 + 16) = key * 21
    key = (key * pow(21, -1, 1 << 64)) & mask
    # Invert key ^= key >> 14 (exact xor ladder: shifts 14,28,42,56)
    key = key ^ (key >> 14) ^ (key >> 28) ^ (key >> 42) ^ (key >> 56)
    # Invert key = key * (1 + 8 + 256) = key * 265
    key = (key * pow(265, -1, 1 << 64)) & mask
    # Invert key ^= key >> 24 (exact ladder: shifts 24, 48)
    key = key ^ (key >> 24) ^ (key >> 48)
    # Invert key = ~key + (key << 21) = (2^21 - 1)*key - 1... solve directly:
    key = ((key + 1) * pow((1 << 21) - 1, -1, 1 << 64)) & mask
    return key


def superfasthash(data: bytes) -> int:
    """Paul Hsieh's SuperFastHash — host parity shim.

    The reference ships it in its hash library (src/hashfuncs.cpp:132-175)
    but never calls it anywhere in the pipeline; it exists purely as API
    surface, so a host implementation completes parity (distribution-only,
    zero output impact). Implemented from the public algorithm: 16-bit
    little-endian block mixing, a 3/2/1-byte tail, and the final avalanche
    ladder.
    """
    n = len(data)
    if n == 0:
        return 0
    mask = 0xFFFFFFFF
    h = n & mask
    get16 = lambda i: data[i] | (data[i + 1] << 8)
    i = 0
    for _ in range(n >> 2):
        h = (h + get16(i)) & mask
        tmp = ((get16(i + 2) << 11) ^ h) & mask
        h = ((h << 16) ^ tmp) & mask
        h = (h + (h >> 11)) & mask
        i += 4
    rem = n & 3
    if rem == 3:
        h = (h + get16(i)) & mask
        h ^= (h << 16) & mask
        # Tail byte is signed char in the original; bytes are unsigned
        # 0..255 here, identical for ASCII payloads (the only use case).
        h ^= (data[i + 2] << 18) & mask
        h = (h + (h >> 11)) & mask
    elif rem == 2:
        h = (h + get16(i)) & mask
        h ^= (h << 11) & mask
        h = (h + (h >> 17)) & mask
    elif rem == 1:
        h = (h + data[i]) & mask
        h ^= (h << 10) & mask
        h = (h + (h >> 1)) & mask
    h ^= (h << 3) & mask
    h = (h + (h >> 5)) & mask
    h ^= (h << 4) & mask
    h = (h + (h >> 17)) & mask
    h ^= (h << 25) & mask
    h = (h + (h >> 6)) & mask
    return h
