"""Brute-force oracles for tests (pure Python/numpy, no JAX).

Defines the ground-truth semantics the device pipeline must reproduce:
canonical k-mer = lexicographic min(seq, revcomp(seq)) with A<C<G<T and
N (or any non-ACGT char) read as A — exactly the reference's behavior
(include/kmer.hpp GetRep + include/dnaseq.hpp codetab).
"""

from __future__ import annotations

from collections import Counter
from typing import Sequence

_COMP = str.maketrans("ACGT", "TGCA")
_CLEAN = {c: "A" for c in "NnRYSWKMBDHVryswkmbdhv"}


def normalize(read: str) -> str:
    """Uppercase and map non-ACGT to A (reference dnaseq.hpp codetab)."""
    s = read.upper()
    return "".join(ch if ch in "ACGT" else "A" for ch in s)


def revcomp(s: str) -> str:
    return s.translate(_COMP)[::-1]


def canonical(s: str) -> str:
    rc = revcomp(s)
    return s if s <= rc else rc


def oracle_counts(reads: Sequence[str], k: int) -> Counter:
    """Unfiltered canonical k-mer counts."""
    counts: Counter = Counter()
    for read in reads:
        s = normalize(read)
        for i in range(len(s) - k + 1):
            counts[canonical(s[i : i + k])] += 1
    return counts


def oracle_filtered(
    reads: Sequence[str], k: int, lower: int, upper: int
) -> dict[str, int]:
    """[L, U]-filtered counts: the reference's final KmerList content."""
    return {
        kmer: c
        for kmer, c in oracle_counts(reads, k).items()
        if lower <= c <= upper
    }


def oracle_histogram(filtered: dict[str, int]) -> dict[int, int]:
    """count -> number of kmers with that count (print_kmer_histogram)."""
    hist: Counter = Counter(filtered.values())
    return dict(hist)


def random_reads(
    rng, n_reads: int, min_len: int, max_len: int, alphabet: str = "ACGT"
) -> list[str]:
    lens = rng.integers(min_len, max_len + 1, size=n_reads)
    return [
        "".join(rng.choice(list(alphabet), size=l)) for l in lens
    ]


def oracle_minimizer_dests(
    read: str, k: int, m: int, num_buckets: int, hash_fn
) -> list[int]:
    """Per-k-mer destination via explicit window scan (oracle for ops/minimizer)."""
    s = normalize(read)
    mhash = [hash_fn(canonical(s[i : i + m])) for i in range(len(s) - m + 1)]
    dests = []
    for i in range(len(s) - k + 1):
        dests.append(min(mhash[i : i + k - m + 1]) % num_buckets)
    return dests


def oracle_occurrences(reads: Sequence[str], k: int) -> dict[str, set]:
    """canonical kmer -> {(read_id, pos), ...} over all occurrences —
    the EXTENSION-mode payload oracle (reference src/kmerops.cpp:1430-1438)."""
    occ: dict[str, set] = {}
    for rid, read in enumerate(reads):
        r = normalize(read)
        for i in range(len(r) - k + 1):
            occ.setdefault(canonical(r[i : i + k]), set()).add((rid, i))
    return occ


# ---------------------------------------------------------------------------
# Vectorized numpy reference, for read sets too large for the dict oracles
# above. Independent of the device code: keys are packed 32 bases per
# uint64 by shift-or doubling over forward and complemented-backward base
# streams, canonicalized by word-lexicographic min, then sorted and
# run-length counted on the host.
# ---------------------------------------------------------------------------

import dataclasses as _dataclasses

import numpy as _np

_ASCII_TO_CODE = _np.zeros(256, dtype=_np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _ASCII_TO_CODE[_b] = _i
    _ASCII_TO_CODE[_b + 32] = _i  # lowercase


def ascii_to_codes(seq: _np.ndarray) -> _np.ndarray:
    """ASCII bases -> 2-bit codes, non-ACGT read as A (normalize above)."""
    return _ASCII_TO_CODE[_np.asarray(seq, dtype=_np.uint8)]


def _pack32(c: _np.ndarray, backward: bool) -> _np.ndarray:
    """p[i] = the 32 bases c[i], c[i+1], ... (or c[i], c[i-1], ... when
    backward) packed big-endian into one uint64; positions whose window
    runs off the array hold garbage and are never read."""
    p = c.astype(_np.uint64)
    for step in (1, 2, 4, 8, 16):
        sh = _np.uint64(2 * step)
        nxt = _np.zeros_like(p)
        if backward:
            nxt[step:] = p[:-step]
        else:
            nxt[:-step] = p[step:]
        p = (p << sh) | nxt
    return p


def _kmer_words64(codes: _np.ndarray, starts: _np.ndarray, k: int, lo: int):
    """Canonical k-mers starting at flat positions `starts` (relative to
    `lo` in `codes`) as a list of ceil(k/32) left-aligned uint64 words."""
    nw = -(-k // 32)
    fwd = _pack32(codes, backward=False)
    rev = _pack32(3 - codes.astype(_np.int16), backward=True)
    rel = starts - lo
    f_words, r_words = [], []
    for w in range(nw):
        bases = min(32, k - 32 * w)
        mask = _np.uint64(((1 << (2 * bases)) - 1) << (64 - 2 * bases))
        f_words.append(fwd[rel + 32 * w] & mask)
        r_words.append(rev[rel + k - 1 - 32 * w] & mask)
    less = _np.zeros(starts.size, dtype=bool)
    eq = _np.ones(starts.size, dtype=bool)
    for fw, rw in zip(f_words, r_words):
        less |= eq & (rw < fw)
        eq &= rw == fw
    return [_np.where(less, rw, fw) for fw, rw in zip(f_words, r_words)]


def _words64_to_keys32(words64: list, k: int) -> _np.ndarray:
    """Left-aligned uint64 words -> (M, ceil(k/16)) uint32 keys in the
    device's layout (16 bases per word, base 0 at the top of word 0)."""
    cols = []
    for w in words64:
        cols.append((w >> _np.uint64(32)).astype(_np.uint32))
        cols.append((w & _np.uint64(0xFFFFFFFF)).astype(_np.uint32))
    return _np.stack(cols[: -(-k // 16)], axis=-1)


@_dataclasses.dataclass
class ReferenceCount:
    """The numpy reference's answer for one read set."""

    keys: _np.ndarray  # (M, W) uint32, ascending, within [lower, upper]
    counts: _np.ndarray  # (M,) int64
    hist: _np.ndarray  # (upper + 1,) int64
    n_kmers: int  # k-mer occurrences counted
    n_distinct: int  # distinct canonical k-mers before the filter


def reference_count(
    codes: _np.ndarray,
    lengths: _np.ndarray,
    k: int,
    lower: int,
    upper: int,
    chunk: int = 1 << 23,
) -> ReferenceCount:
    """Count canonical k-mers of flat 2-bit `codes` split into reads of
    `lengths`, keep counts in [lower, upper], and histogram them.

    Chunked over the flat base stream, so transient memory is a few
    uint64 arrays of `chunk` elements beside the keys themselves.
    """
    codes = _np.asarray(codes, dtype=_np.uint8)
    lengths = _np.asarray(lengths, dtype=_np.int64)
    n = codes.size
    ends = _np.cumsum(lengths)
    nk = _np.maximum(lengths - k + 1, 0)
    # Start positions of every k-mer, in flat order.
    first = ends - lengths
    kstart = _np.cumsum(nk) - nk
    starts = _np.arange(int(nk.sum()), dtype=_np.int64) + _np.repeat(
        first - kstart, nk
    )
    nw = -(-k // 32)
    words = [_np.empty(starts.size, dtype=_np.uint64) for _ in range(nw)]
    halo = k + 32
    for lo in range(0, max(n, 1), chunk):
        a = _np.searchsorted(starts, lo)
        b = _np.searchsorted(starts, lo + chunk)
        if a == b:
            continue
        seg = _np.zeros(chunk + halo, dtype=_np.uint8)
        piece = codes[lo : lo + chunk + halo]
        seg[: piece.size] = piece
        # Backward windows reach 31 bases before a k-mer's last base,
        # which is at most k-1 after its start: no left halo is needed.
        got = _kmer_words64(seg, starts[a:b], k, lo)
        for w in range(nw):
            words[w][a:b] = got[w]
    del starts
    if nw == 1:
        order = None
        words[0].sort()
        srt = words
    else:
        order = _np.lexsort(tuple(reversed(words)))
        srt = [w[order] for w in words]
    del order
    m = srt[0].size
    head = _np.ones(m, dtype=bool)
    if m:
        diff = _np.zeros(m - 1, dtype=bool)
        for w in srt:
            diff |= w[1:] != w[:-1]
        head[1:] = diff
    head_idx = _np.flatnonzero(head)
    counts = _np.diff(_np.append(head_idx, m))
    keep = (counts >= lower) & (counts <= upper)
    kept = head_idx[keep]
    keys = _words64_to_keys32([w[kept] for w in srt], k)
    hist = _np.bincount(counts[keep], minlength=upper + 1)[: upper + 1]
    return ReferenceCount(
        keys=keys,
        counts=counts[keep],
        hist=hist,
        n_kmers=int(m),
        n_distinct=int(head_idx.size),
    )


# ---------------------------------------------------------------------------
# Simulated short-read WGS: a random genome with repeat families, reads
# drawn uniformly from both strands with substitution errors and a few N
# runs. Everything is drawn from one seed.
# ---------------------------------------------------------------------------


@_dataclasses.dataclass
class SimulatedReads:
    reads: _np.ndarray  # (R, L) uint8 ASCII in "ACGTN"
    genome_len: int
    n_errors: int  # substituted bases
    n_n_bases: int  # bases overwritten with N

    @property
    def lengths(self) -> _np.ndarray:
        return _np.full(self.reads.shape[0], self.reads.shape[1], _np.int64)

    def codes(self) -> _np.ndarray:
        return ascii_to_codes(self.reads.reshape(-1))

    def prefix(self, bases: int) -> "SimulatedReads":
        """The first whole reads holding at most `bases` bases."""
        r = max(bases // self.reads.shape[1], 1)
        return SimulatedReads(
            self.reads[:r], self.genome_len, self.n_errors, self.n_n_bases
        )


def simulate_reads(
    seed: int,
    genome_len: int = 5_000_000,
    coverage: float = 30.0,
    read_len: int = 150,
    n_families: int = 60,
    copies_per_family: int = 5,
    unit_len: tuple[int, int] = (1000, 5000),
    divergence: tuple[float, float] = (0.01, 0.03),
    error_rate: float = 0.005,
    n_reads_with_n: int = 25,
) -> SimulatedReads:
    """Short reads at `coverage` over a random genome whose repeat families
    (n_families x copies_per_family copies of 1-5 kb units at 1-3%
    divergence) make heavy-hitter k-mers."""
    rng = _np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=genome_len, dtype=_np.uint8)
    for _ in range(n_families):
        ulen = int(rng.integers(unit_len[0], unit_len[1] + 1))
        ulen = min(ulen, genome_len // 2)
        unit = rng.integers(0, 4, size=ulen, dtype=_np.uint8)
        for _ in range(copies_per_family):
            copy = unit.copy()
            div = rng.uniform(*divergence)
            hits = rng.random(ulen) < div
            copy[hits] = (copy[hits] + rng.integers(1, 4, hits.sum())) % 4
            at = int(rng.integers(0, genome_len - ulen + 1))
            genome[at : at + ulen] = copy
    n_reads = int(coverage * genome_len / read_len)
    starts = rng.integers(0, genome_len - read_len + 1, size=n_reads)
    reads = genome[starts[:, None] + _np.arange(read_len)]
    rc = rng.random(n_reads) < 0.5
    reads[rc] = 3 - reads[rc, ::-1]
    flat = reads.reshape(-1)
    n_err = int(rng.binomial(flat.size, error_rate))
    where = rng.choice(flat.size, size=n_err, replace=False)
    flat[where] = (flat[where] + rng.integers(1, 4, n_err)) % 4
    ascii = _np.frombuffer(b"ACGTN", dtype=_np.uint8)[reads]
    n_n = 0
    for r in rng.choice(n_reads, size=min(n_reads_with_n, n_reads), replace=False):
        run = int(rng.integers(5, 31))
        at = int(rng.integers(0, read_len - run + 1))
        ascii[r, at : at + run] = ord("N")
        n_n += run
    return SimulatedReads(ascii, genome_len, n_err, n_n)


def write_fasta(path: str, reads: _np.ndarray, width: int = 60) -> None:
    """Write (R, L) ASCII reads as a FASTA with `width`-column lines."""
    n_reads, read_len = reads.shape
    cuts = list(range(width, read_len, width))
    parts = _np.split(reads, cuts, axis=1)
    nl = _np.full((n_reads, 1), ord("\n"), dtype=_np.uint8)
    digits = max(len(str(max(n_reads - 1, 0))), 1)
    headers = _np.frombuffer(
        b"".join(b">r%0*d\n" % (digits, i) for i in range(n_reads)),
        dtype=_np.uint8,
    ).reshape(n_reads, digits + 3)
    cols = [headers]
    for part in parts:
        cols += [part, nl]
    with open(path, "wb") as f:
        _np.concatenate(cols, axis=1).tofile(f)


def pack_ascii_kmers(kmers: _np.ndarray) -> _np.ndarray:
    """(M, k) ASCII k-mers -> (M, ceil(k/16)) uint32 keys, device layout."""
    m, k = kmers.shape
    codes = ascii_to_codes(kmers).astype(_np.uint32)
    w_count = -(-k // 16)
    out = _np.zeros((m, w_count), dtype=_np.uint32)
    for i in range(k):
        w, j = divmod(i, 16)
        out[:, w] |= codes[:, i] << _np.uint32(2 * (15 - j))
    return out


def read_output_file(path: str, k: int) -> tuple[_np.ndarray, _np.ndarray]:
    """Parse a `kmer\\tcount` output file into ((M, W) uint32 keys,
    (M,) int64 counts), vectorized for files of millions of lines."""
    buf = _np.fromfile(path, dtype=_np.uint8)
    nl = _np.flatnonzero(buf == ord("\n"))
    starts = _np.concatenate([[0], nl[:-1] + 1]).astype(_np.int64)
    if nl.size == 0:
        return _np.zeros((0, -(-k // 16)), _np.uint32), _np.zeros(0, _np.int64)
    if not (buf[starts + k] == ord("\t")).all():
        raise ValueError(f"{path}: not {k}-mer\\tcount lines")
    kmers = buf[starts[:, None] + _np.arange(k)]
    counts = _np.zeros(nl.size, dtype=_np.int64)
    first = starts + k + 1
    for d in range(int((nl - first).max())):
        idx = first + d
        has = idx < nl
        digit = buf[_np.minimum(idx, buf.size - 1)].astype(_np.int64) - 48
        counts = _np.where(has, counts * 10 + digit, counts)
    return pack_ascii_kmers(kmers), counts


def sorted_rows(keys: _np.ndarray, counts: _np.ndarray):
    """(keys, counts) reordered by ascending key, for order-free equality."""
    keys = _np.asarray(keys, dtype=_np.uint32)
    order = _np.lexsort(tuple(keys[:, w] for w in range(keys.shape[1] - 1, -1, -1)))
    return keys[order], _np.asarray(counts, dtype=_np.int64)[order]


def same_counts(keys_a, counts_a, keys_b, counts_b) -> bool:
    """Exact equality of two {key: count} sets given as arrays."""
    ka, ca = sorted_rows(keys_a, counts_a)
    kb, cb = sorted_rows(keys_b, counts_b)
    return ka.shape == kb.shape and bool((ka == kb).all() and (ca == cb).all())
