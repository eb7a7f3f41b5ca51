"""Runtime configuration for the k-mer counting engine.

The reference (HySortK) fixes every parameter at compile time via -D macros
(reference: Makefile:1-46, include/compiletime.h:10-21). Here the parameters
are a runtime dataclass; `k` and `m` still specialize the jitted kernels
(each (k, m) pair triggers one trace/compile, the analogue of one `make K=..`
build of the reference).
"""

from __future__ import annotations

import dataclasses


def words_per_kmer(k: int) -> int:
    """Number of 32-bit words used to pack a k-mer (16 bases / word).

    The reference packs into 64-bit longs, 32 bases per long
    (reference: include/kmer.hpp:21-28, TKmer select at kmer.hpp:343-345).
    Here keys are uint32 words; both layouts are big-endian per base, so
    lexicographic word order == DNA string order.
    """
    return (k + 15) // 16


@dataclasses.dataclass(frozen=True)
class KmerConfig:
    """All knobs of the pipeline.

    Mirrors the reference's compile-time macro surface
    (reference: Makefile:39-46, include/compiletime.h):
      k      <-> KMER_SIZE   (2 < k <= 96)
      m      <-> MINIMIZER_SIZE (m < k)
      lower  <-> LOWER_KMER_FREQ
      upper  <-> UPPER_KMER_FREQ (<= 65535)
      extension <-> EXTENSION (carry ReadId+PosInRead payloads)
      avg_buckets_per_shard <-> AVG_TASK_PER_WORKER (virtual-task oversubscription)
      heavy_ratio <-> UNBALANCED_RATIO (heavy-hitter threshold, 2.3)
      combiner: always-on local pre-aggregation before exchange, subsuming the
                reference's heavy-hitter ScatteredKmerList path
                (reference: src/kmerops.cpp:363-417).
    """

    k: int = 31
    m: int = 17
    lower: int = 15
    upper: int = 40
    extension: bool = False

    # Distribution knobs (multi-device path).
    # routing:
    #   "range"     (default) — sort each shard once in an invertibly-mixed
    #               key space and carve contiguous per-destination segments
    #               out of the sorted order (ops/mixkey.py); receivers get
    #               sorted runs and only merge. One sort + one merge per
    #               step.
    #   "kmer_hash" — legacy: dest = hash(key) % shards, grouped by an
    #               extra destination sort before the exchange and fully
    #               re-sorted after it.
    #   "minimizer" — the reference's virtual-task scheme: dest bucket =
    #               minimizer hash % (shards * avg_buckets_per_shard) with
    #               bucket->shard placement from the balanced dispatcher
    #               (reference src/kmerops.cpp:1044-1047, 1274-1327).
    #   "supermer"  — the reference's exchange architecture end-to-end:
    #               host-side minimizer dispatch ships per-shard supermer
    #               run streams (lengths + 2-bit bases, ~0.28 B/base) over
    #               the wire and each shard counts locally with NO device
    #               all_to_all (parallel/supermer_route.py; reference
    #               src/kmerops.cpp:1096-1148, 587-643).
    routing: str = "range"
    avg_buckets_per_shard: int = 3
    heavy_ratio: float = 2.3
    combiner: bool = False

    # Bucket->shard placement under minimizer routing: "balanced" = the
    # reference's BalancedDispatcher first-fit sweep
    # (src/kmerops.cpp:1274-1327); "round_robin" = i % shards
    # (RoundRobinDispatcher, src/kmerops.cpp:1201-1211).
    dispatcher: str = "balanced"

    # classifier: "heavy_hitter" runs a cheap measurement pass before the
    # sharded step — exact per-(src,dst) slot maxima pre-size the exchange
    # capacity (no recompile-retry on skew) and destinations heavier than
    # heavy_ratio x mean auto-enable the combiner (the reference's
    # HeavyHitterClassifier, src/kmerops.cpp:1157-1199). "plain" skips the
    # measurement (reference PLAIN_CLASSIFIER) and falls back to
    # capacity_factor sizing with overflow-retry.
    classifier: str = "heavy_hitter"

    # Exchange capacity over-provisioning factor: per-(src,dst) slot capacity is
    # ceil(n_local / n_shards * capacity_factor). Analogous in spirit to the
    # reference's DISPATCH_UPPER_COE sweep (reference: Makefile:28-33).
    capacity_factor: float = 1.6

    # Device batch sizing: flat base-stream padding granularity.
    pad_multiple: int = 1024

    # Compact results ON DEVICE before the host pull: fold dropped slots to
    # the sentinel, one extra (keys + count) payload sort, then the host
    # fetches exact-size prefixes instead of full padded arrays + mask.
    # Trades one device sort per batch for a smaller device->host pull;
    # off by default. The reference has no analogue (its sort output lives
    # in the same address space it counts from).
    device_compact: bool = False

    # Internal: emit every distinct key with its raw count ([1, inf) filter).
    # Used by streaming pre-counts, whose partials must never be clipped
    # (the final merge applies the real [lower, upper]); not a user knob.
    unfiltered: bool = False

    def __post_init__(self):
        if not (2 < self.k <= 96):
            raise ValueError(f"k must be in (2, 96], got {self.k}")
        if not (0 < self.m < self.k):
            # Same envelope as the reference (M < K, Makefile:50-52); the
            # minimizer machinery packs m-mers with the same W-word code
            # path as k-mers, so any m < k <= 96 works.
            raise ValueError(f"m must be in (0, k), got m={self.m} k={self.k}")
        if self.lower < 1:
            raise ValueError(f"lower must be >= 1, got {self.lower}")
        if not (self.lower <= self.upper <= 65535):
            raise ValueError(
                f"need lower <= upper <= 65535, got [{self.lower}, {self.upper}]"
            )
        if self.routing not in ("range", "kmer_hash", "minimizer", "supermer"):
            raise ValueError(f"unknown routing {self.routing!r}")
        if self.classifier not in ("heavy_hitter", "plain"):
            raise ValueError(f"unknown classifier {self.classifier!r}")
        if self.dispatcher not in ("balanced", "round_robin"):
            raise ValueError(f"unknown dispatcher {self.dispatcher!r}")
        if self.extension and self.combiner:
            # Pre-aggregation would collapse per-occurrence payloads; the
            # reference likewise disables its heavy-hitter path under
            # EXTENSION (src/kmerops.cpp:109-113).
            raise ValueError("combiner is unavailable in extension mode")

    @property
    def words(self) -> int:
        """uint32 words per packed k-mer key."""
        return words_per_kmer(self.k)

    @property
    def mwords(self) -> int:
        """uint32 words per packed minimizer."""
        return words_per_kmer(self.m)

    @property
    def window(self) -> int:
        """Minimizer window: number of m-mers inside one k-mer."""
        return self.k - self.m + 1
