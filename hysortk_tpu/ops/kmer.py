"""Device-side packed canonical k-mer key construction.

Data-parallel redesign of the reference's Kmer<NLONGS> rolling-extension scan
(reference: include/kmer.hpp:107-345). Instead of a sequential per-read loop
extending one k-mer at a time, every k-mer key of the whole flat base stream is
built bit-parallel:

  1. `sliding_pack16` packs, for every position i, the 16 bases starting at i
     into one big-endian uint32 — in 4 shift-OR doubling steps (log2(16)),
     each a vectorized roll. No gathers, no data-dependent control flow.
  2. A k-mer key is W = ceil(k/16) such words sampled 16 apart; the last word
     keeps only its top 2r bits (r = k - 16*(W-1)).
  3. The reverse complement ("twin", reference kmer.hpp GetTwin) is computed
     from the forward key purely with bit tricks: reverse the 2-bit groups of
     each word (3 mask/swap rounds), reverse word order, complement (the 2-bit
     DNA code has complement == bitwise NOT), and realign with a multiword
     left shift. No lookup tables (reference uses a 256-entry tetramer LUT).
  4. Canonical representative = lexicographic min(forward, twin), identical in
     semantics to reference GetRep (kmer.hpp:316-321): big-endian packing makes
     uint32 word-lexicographic order equal to DNA string order with A<C<G<T.

All arrays are flat over the concatenated base stream of all reads; a boolean
validity mask (computed host-side from read lengths) marks positions where a
k-mer window starts inside a single read. Wrap-around garbage from `roll` at
the stream tail only ever lands on invalid positions.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

_U32 = jnp.uint32
_FULL = 0xFFFFFFFF


def sliding_pack16(codes: jnp.ndarray) -> jnp.ndarray:
    """For each position i, pack bases codes[i..i+15] big-endian into a uint32.

    codes: (N,) integer array with values in [0, 3].
    Returns (N,) uint32; entries within 15 of the end contain wrapped garbage.
    """
    p = codes.astype(_U32)
    p = (p << 2) | jnp.roll(p, -1)   # 2 bases
    p = (p << 4) | jnp.roll(p, -2)   # 4 bases
    p = (p << 8) | jnp.roll(p, -4)   # 8 bases
    p = (p << 16) | jnp.roll(p, -8)  # 16 bases
    return p


def forward_words(pack16: jnp.ndarray, k: int) -> list[jnp.ndarray]:
    """W uint32 words of the forward k-mer key starting at each position."""
    w_count = (k + 15) // 16
    r = k - 16 * (w_count - 1)  # bases in the last word, 1..16
    words = []
    for w in range(w_count):
        word = pack16 if w == 0 else jnp.roll(pack16, -16 * w)
        if w == w_count - 1 and r < 16:
            word = word & _U32((_FULL << (32 - 2 * r)) & _FULL)
        words.append(word)
    return words


def crumb_reverse32(x: jnp.ndarray) -> jnp.ndarray:
    """Reverse the sixteen 2-bit groups of each uint32."""
    x = (x >> 16) | (x << 16)
    x = ((x & _U32(0xFF00FF00)) >> 8) | ((x & _U32(0x00FF00FF)) << 8)
    x = ((x & _U32(0xF0F0F0F0)) >> 4) | ((x & _U32(0x0F0F0F0F)) << 4)
    x = ((x & _U32(0xCCCCCCCC)) >> 2) | ((x & _U32(0x33333333)) << 2)
    return x


def twin_words(fwd: list[jnp.ndarray], k: int) -> list[jnp.ndarray]:
    """Reverse-complement key words from the forward key words.

    Matches reference GetTwin (include/kmer.hpp:269-299) semantics: complement
    of the 2-bit code is its bitwise NOT, and the reversed bit stream must be
    realigned so the first twin base sits at the top of word 0.
    """
    w_count = len(fwd)
    rev = [~crumb_reverse32(fwd[w_count - 1 - w]) for w in range(w_count)]
    shift = 32 * w_count - 2 * k
    if shift == 0:
        return rev
    out = []
    for w in range(w_count):
        hi = rev[w] << shift
        lo = (rev[w + 1] >> (32 - shift)) if w + 1 < w_count else _U32(0)
        out.append(hi | lo)
    return out


def lex_less(a: list[jnp.ndarray], b: list[jnp.ndarray]) -> jnp.ndarray:
    """Elementwise lexicographic a < b over word lists (word 0 most significant)."""
    less = jnp.zeros(a[0].shape, dtype=jnp.bool_)
    eq = jnp.ones(a[0].shape, dtype=jnp.bool_)
    for aw, bw in zip(a, b):
        less = less | (eq & (aw < bw))
        eq = eq & (aw == bw)
    return less


def canonical_words(codes: jnp.ndarray, k: int) -> list[jnp.ndarray]:
    """Canonical (min of forward/revcomp) packed key words at every position."""
    p16 = sliding_pack16(codes)
    fwd = forward_words(p16, k)
    twn = twin_words(fwd, k)
    t_less = lex_less(twn, fwd)
    return [jnp.where(t_less, tw, fw) for fw, tw in zip(fwd, twn)]


# ---------------------------------------------------------------------------
# Host-side (numpy) helpers: decode packed keys to ASCII, encode strings.
# Used by writers, tests and tooling — not on the device hot path.
# ---------------------------------------------------------------------------

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def decode_keys(keys: np.ndarray, k: int) -> np.ndarray:
    """(N, W) uint32 packed keys -> (N,) array of length-k ASCII bytes objects.

    Inverse of the packing above; equivalent to reference Kmer::GetString
    (include/kmer.hpp:147-163) modulo the 32- vs 64-bit word layout.
    """
    keys = np.asarray(keys, dtype=np.uint32)
    n = keys.shape[0]
    try:
        from ..io import native

        if n >= 4096 and native.available():
            out = native.decode_keys(keys, k)
            if out is not None:
                return out
    except ImportError:
        pass
    chars = np.empty((n, k), dtype=np.uint8)
    for i in range(k):
        w, j = divmod(i, 16)
        code = (keys[:, w] >> np.uint32(2 * (15 - j))) & np.uint32(3)
        chars[:, i] = _BASES[code]
    return chars.view(f"S{k}").reshape(n)


def encode_kmer(s: str) -> np.ndarray:
    """ASCII k-mer -> (W,) uint32 packed key (host-side oracle helper)."""
    k = len(s)
    w_count = (k + 15) // 16
    out = np.zeros(w_count, dtype=np.uint32)
    code = {"A": 0, "C": 1, "G": 2, "T": 3, "N": 0}
    for i, ch in enumerate(s.upper()):
        w, j = divmod(i, 16)
        out[w] |= np.uint32(code[ch] << (2 * (15 - j)))
    return out


def extend_kmer(key: np.ndarray, code: int, k: int) -> np.ndarray:
    """Shift one base into a packed (W,) uint32 forward key: the rolling
    k-mer builder's step next = ((kmer << 2) | code) truncated to k bases
    (reference Kmer::GetExtension, include/kmer.hpp:248-262; used by its
    sequence scanner at :328). Works on numpy or jax arrays alike — the
    ops are plain shifts/ors.

    Layout matches encode_kmer: base 0 in the top crumb of word 0; the
    last word's unused low bits stay zero.
    """
    w_count = (k + 15) // 16
    assert key.shape[-1] == w_count, (key.shape, w_count)
    two = key.dtype.type(2)
    shifted = [key[..., i] << two for i in range(w_count)]
    for i in range(w_count - 1):
        shifted[i] = shifted[i] | (key[..., i + 1] >> key.dtype.type(30))
    # Deposit the new base at position k-1 and re-mask the tail word.
    w, j = divmod(k - 1, 16)
    shifted[w] = shifted[w] | key.dtype.type(
        (int(code) & 3) << (2 * (15 - j))
    )
    r_last = k - 16 * (w_count - 1)
    if r_last < 16:
        shifted[-1] = shifted[-1] & key.dtype.type(
            (0xFFFFFFFF << (32 - 2 * r_last)) & 0xFFFFFFFF
        )
    if isinstance(key, np.ndarray):
        return np.stack(shifted, axis=-1)
    import jax.numpy as jnp

    return jnp.stack(shifted, axis=-1)
