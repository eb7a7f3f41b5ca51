"""Single-device end-to-end k-mer counting pipeline.

The device computation mirrors the reference's three phases
(kmer_count, src/hysortk.cpp:36-95) collapsed into one fused jitted program:

  prepare  (canonical key construction; reference prepare_supermer)
  sort     (multiword key sort; reference sort_task / PARADIS / RADULS)
  count    (run-length + [L,U] filter + histogram; reference filter_kmer)

The multi-device version lives in parallel/pipeline.py; this module is both
the one-device path and the correctness anchor for everything else.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from .config import KmerConfig
from .ops import count as count_ops
from .ops import kmer as kmer_ops
from .ops import sort as sort_ops


@dataclasses.dataclass
class KmerList:
    """Filtered {kmer, count} result on host.

    keys:   (M, W) uint32 packed canonical keys
    counts: (M,) int32 frequencies, all within [lower, upper]
    Analogue of the reference's KmerListS (include/kmer.hpp:348-360).
    """

    keys: np.ndarray
    counts: np.ndarray
    k: int

    def __len__(self) -> int:
        return int(self.keys.shape[0])

    def decoded(self) -> np.ndarray:
        return kmer_ops.decode_keys(self.keys, self.k)

    def as_dict(self) -> dict[bytes, int]:
        return dict(zip(self.decoded().tolist(), self.counts.tolist()))


@dataclasses.dataclass
class KmerListExt:
    """Extension-mode result: per-kmer occurrence payloads.

    pos[j]/rid[j] are the PosInRead / global ReadId arrays of all counts[j]
    occurrences of keys[j] — the reference's EXTENSION=1 KmerListEntryS
    (include/kmer.hpp:346-400, populated at src/kmerops.cpp:1430-1438).
    """

    keys: np.ndarray
    counts: np.ndarray
    k: int
    pos: list[np.ndarray] = dataclasses.field(default_factory=list)
    rid: list[np.ndarray] = dataclasses.field(default_factory=list)

    def __len__(self) -> int:
        return int(self.keys.shape[0])

    def decoded(self) -> np.ndarray:
        return kmer_ops.decode_keys(self.keys, self.k)

    def as_dict(self) -> dict[bytes, tuple[int, set]]:
        """kmer -> (count, {(rid, pos), ...}) for order-free comparison."""
        out = {}
        for km, c, p, r in zip(
            self.decoded().tolist(), self.counts.tolist(), self.pos, self.rid
        ):
            out[km] = (int(c), set(zip(r.tolist(), p.tolist())))
        return out


@functools.partial(jax.jit, static_argnames=("k", "lower", "upper"))
def _count_device_ext(
    codes: jnp.ndarray,
    valid: jnp.ndarray,
    rid: jnp.ndarray,
    pos: jnp.ndarray,
    k: int,
    lower: int,
    upper: int,
):
    """Extension-mode device pipeline: payloads ride the sort as extra operands
    (the reference instead widens KmerSeedStruct, include/kmer.hpp:402-430)."""
    words = kmer_ops.canonical_words(codes.astype(jnp.int32), k)
    invalid = (~valid).astype(jnp.uint32)
    inv_s, words_s, payloads_s = sort_ops.sort_keys(
        invalid,
        words,
        payloads=[rid.astype(jnp.uint32), pos.astype(jnp.uint32)],
    )
    svalid = inv_s == 0
    head, cnt = count_ops.run_length_count(svalid, words_s)
    keep = count_ops.frequency_filter(head, cnt, lower, upper)
    # Words stay separate (N,) arrays: stacking to (N, W) on device would
    # cost a full extra HBM write + read; the host stacks after compaction.
    return tuple(words_s), cnt, keep, payloads_s[0], payloads_s[1]


def assemble_ext_result(keys, cnt, keep, srid, spos, cfg) -> "KmerListExt":
    """Host assembly of EXT device outputs: compact kept keys, slice the
    sorted payload streams into per-kmer occurrence lists."""
    keep_np = np.asarray(keep)
    cnt_np = np.asarray(cnt)
    srid_np = np.asarray(srid).astype(np.int32)
    spos_np = np.asarray(spos).astype(np.uint32)
    starts = np.flatnonzero(keep_np)
    counts = cnt_np[starts]
    pos_runs, rid_runs = split_occurrences(starts, counts, spos_np, srid_np)
    return KmerListExt(
        keys=compact_keys(keys, keep_np),
        counts=counts,
        k=cfg.k,
        pos=pos_runs,
        rid=rid_runs,
    )


def count_flat_ext(
    codes: np.ndarray,
    valid: np.ndarray,
    rid: np.ndarray,
    pos: np.ndarray,
    cfg: KmerConfig,
) -> tuple[KmerListExt, np.ndarray]:
    """Extension-mode host wrapper: slices the sorted payload stream into
    per-kmer occurrence lists (ragged assembly stays host-side)."""
    lower, upper = (
        (1, 2**31 - 1) if cfg.unfiltered else (cfg.lower, cfg.upper)
    )
    keys, cnt, keep, srid, spos = _count_device_ext(
        jnp.asarray(codes, dtype=jnp.int8),
        jnp.asarray(valid),
        jnp.asarray(rid),
        jnp.asarray(pos),
        cfg.k,
        lower,
        upper,
    )
    result = assemble_ext_result(keys, cnt, keep, srid, spos, cfg)
    return result, host_histogram(result.counts, cfg.upper)


def count_reads_ext(
    codes: np.ndarray,
    lengths: np.ndarray,
    cfg: KmerConfig,
    read_id_offset: int = 0,
) -> tuple[KmerListExt, np.ndarray]:
    from .io import fasta as fasta_io

    flat, valid, rid, pos = fasta_io.flatten_for_device_ext(
        codes, lengths, cfg.k, cfg.pad_multiple, read_id_offset
    )
    return count_flat_ext(flat, valid, rid, pos, cfg)


def _count_core(
    codes: jnp.ndarray,
    valid: jnp.ndarray,
    k: int,
    lower: int,
    upper: int,
):
    """codes (N,) int8, valid (N,) bool -> sorted keys, counts, keep mask.
    Traced under both the raw-array and the packed-wire entry jits."""
    words = kmer_ops.canonical_words(codes.astype(jnp.int32), k)
    invalid = (~valid).astype(jnp.uint32)
    inv_s, words_s, _ = sort_ops.sort_keys(invalid, words)
    svalid = inv_s == 0
    head, cnt = count_ops.run_length_count(svalid, words_s)
    keep = count_ops.frequency_filter(head, cnt, lower, upper)
    # Words stay separate (N,) arrays (stacking would cost an extra HBM
    # round trip); the histogram is computed host-side from the compacted
    # counts — the reference's counting timer likewise excludes histogram
    # work (src/hysortk.cpp:91 vs print_kmer_histogram).
    return tuple(words_s), cnt, keep


_count_device = functools.partial(
    jax.jit, static_argnames=("k", "lower", "upper")
)(_count_core)


@functools.partial(
    jax.jit, static_argnames=("k", "n", "lower", "upper")
)
def _count_device_packed(
    packed: jnp.ndarray,
    lengths: jnp.ndarray,
    k: int,
    n: int,
    lower: int,
    upper: int,
):
    """Wire-fed single-device step: (n/16,) uint32 packed words + (R,) read
    lengths -> decode on device -> count. H2D is ~2 bits/base + 4 B/read
    instead of 9 bits/base (int8 codes + bool mask) — the reference's
    supermer wire density on the feed (src/kmerops.cpp:1096-1148)."""
    from .ops import wire

    codes, valid = wire.decode_block(packed, lengths, k, n)
    return _count_core(codes, valid, k, lower, upper)


@functools.partial(
    jax.jit, static_argnames=("k", "n", "lower", "upper")
)
def _count_device_packed_compact(
    packed: jnp.ndarray,
    lengths: jnp.ndarray,
    k: int,
    n: int,
    lower: int,
    upper: int,
):
    """Wire-fed step + on-device result compaction (cfg.device_compact):
    dropped slots fold to the sentinel and one payload sort moves the kept
    (key, count) entries to an ascending prefix; returns (words, counts,
    n_kept) so the host pulls exact-size slices instead of full padded
    arrays + mask."""
    from .ops import wire

    codes, valid = wire.decode_block(packed, lengths, k, n)
    words_s, cnt, keep = _count_core(codes, valid, k, lower, upper)
    full = jnp.uint32(0xFFFFFFFF)
    folded = [jnp.where(keep, w, full) for w in words_s]
    _, cw, cp = sort_ops.sort_marked(folded, [cnt.astype(jnp.uint32)])
    n_kept = jnp.sum(keep.astype(jnp.int32))
    return tuple(cw), cp[0], n_kept


@functools.partial(
    jax.jit, static_argnames=("k", "n", "lower", "upper")
)
def _count_device_ext_packed(
    packed: jnp.ndarray,
    lengths: jnp.ndarray,
    rid_base: jnp.ndarray,
    k: int,
    n: int,
    lower: int,
    upper: int,
):
    """Wire-fed EXT step: (rid, pos) derive on device from read lengths
    (ops/wire.rid_pos_from_lengths) — EXT H2D equals the non-EXT wire plus
    one scalar."""
    from .ops import wire

    codes, valid, rid, pos = wire.decode_block_ext(packed, lengths, k, n, 0)
    rid = rid + rid_base[0]
    return _count_device_ext(codes, valid, rid, pos, k, lower, upper)


def pull_prefix(
    arrays, n: int, granule: int = 1 << 20
) -> list[np.ndarray]:
    """Fetch the first n elements of device arrays, pulling only a
    granule-rounded prefix (few distinct eager-slice shapes; ~n bytes on
    the wire instead of the full padded arrays)."""
    size = int(arrays[0].shape[0])
    n2 = min(-(-max(n, 1) // granule) * granule, size)
    return [np.asarray(a[:n2])[:n] for a in arrays]


@functools.partial(jax.jit, static_argnames=("dtype",))
def _cast_for_pull(cnt, *, dtype):
    return cnt.astype(dtype)


def narrow_counts(cnt, upper: int):
    """Cast FILTERED device counts to the narrowest dtype `upper` fits
    before the host pull: u8 for U<=255, u16 for U<=65535 (the reference's
    own count bound, compiletime.h:21), else unchanged. Every value in the
    kept prefix is <= upper by the frequency filter, so the cast is exact;
    the compacted tail holds garbage either way and is never read. A
    separate tiny jit, not a dtype variant of the large compact programs,
    so those compile once. This turns the final pull from 12 to 10 (or 9)
    B/row."""
    if upper <= 0xFF:
        return _cast_for_pull(cnt, dtype="uint8")
    if upper <= 0xFFFF:
        return _cast_for_pull(cnt, dtype="uint16")
    return cnt


def split_occurrences(
    starts: np.ndarray, counts: np.ndarray, *arrays: np.ndarray
) -> list[list[np.ndarray]]:
    """Slice per-kmer occurrence runs [start, start+count) out of flat
    sorted payload streams as views (no copies).

    Uses plain-int slicing over pre-tolist'ed bounds: ~0.5 µs per run —
    measured 8x faster than np.split and ~10x faster than slicing with
    numpy scalar indices, which at genome scale (1e6+ distinct k-mers)
    would dominate EXT wall time.
    """
    s_list = starts.tolist()
    e_list = (starts + counts).tolist()
    return [
        [a[s:e] for s, e in zip(s_list, e_list)] for a in arrays
    ]


def merge_ext_partials(
    partials: list["KmerListExt"], lower: int, upper: int, k: int, words: int
) -> "KmerListExt":
    """Merge unfiltered per-batch EXT partials into one filtered result.

    Each partial holds distinct keys with their occurrence payload runs
    from one bounded device batch; equal keys across batches are summed and
    their occurrence lists concatenated (order-free semantics, matching the
    reference's EXTENSION count_sorted_kmers accumulation,
    src/kmerops.cpp:1430-1438). The [L, U] filter applies to the merged
    totals only — exactly the reference's bounded-round behaviour, where
    nothing in the exchange loop is EXT-conditional (kmerops.cpp:906-1007).
    """
    nonempty = [p for p in partials if len(p)]
    if not nonempty:
        return KmerListExt(
            keys=np.zeros((0, words), np.uint32),
            counts=np.zeros(0, np.int32),
            k=k,
        )
    all_keys = np.concatenate([p.keys for p in nonempty], axis=0)
    all_cnts = np.concatenate([p.counts for p in nonempty]).astype(np.int64)
    occ_pos = [a for p in nonempty for a in p.pos]
    occ_rid = [a for p in nonempty for a in p.rid]

    order = np.lexsort(
        tuple(all_keys[:, w] for w in range(all_keys.shape[1] - 1, -1, -1))
    )
    keys_s = all_keys[order]
    head = np.ones(keys_s.shape[0], dtype=bool)
    head[1:] = (keys_s[1:] != keys_s[:-1]).any(axis=1)
    group_starts = np.flatnonzero(head)
    # Integer segment sums (np.bincount weights would accumulate in f64 —
    # exact only below 2^53).
    totals = np.add.reduceat(all_cnts[order], group_starts)
    keep = (totals >= lower) & (totals <= upper)

    # Vectorized occurrence assembly: one flat concatenate, one ragged
    # gather that lays every entry's occurrence run out in group order,
    # then kept groups are contiguous slice views (the split_occurrences
    # trick) — no per-group Python concatenates (those measured seconds at
    # 1e6+ distinct k-mers x multiple batches).
    lens = np.fromiter(
        (a.size for a in occ_pos), dtype=np.int64, count=len(occ_pos)
    )
    entry_starts = np.zeros(lens.size, dtype=np.int64)
    np.cumsum(lens[:-1], out=entry_starts[1:])
    flat_pos = np.concatenate(occ_pos)
    flat_rid = np.concatenate(occ_rid)
    l_ord = lens[order]
    total_occ = int(l_ord.sum())
    out_starts = np.zeros(l_ord.size, dtype=np.int64)
    np.cumsum(l_ord[:-1], out=out_starts[1:])
    gather_idx = (
        np.arange(total_occ, dtype=np.int64)
        - np.repeat(out_starts, l_ord)
        + np.repeat(entry_starts[order], l_ord)
    )
    pos_sorted = flat_pos[gather_idx]
    rid_sorted = flat_rid[gather_idx]
    group_occ = np.add.reduceat(l_ord, group_starts)
    occ_out_starts = np.zeros(group_occ.size, dtype=np.int64)
    np.cumsum(group_occ[:-1], out=occ_out_starts[1:])
    kept = np.flatnonzero(keep)
    pos_out, rid_out = split_occurrences(
        occ_out_starts[kept], group_occ[kept], pos_sorted, rid_sorted
    )
    return KmerListExt(
        keys=keys_s[head][keep],
        counts=totals[keep].astype(np.int32),
        k=k,
        pos=pos_out,
        rid=rid_out,
    )


def flat_size(total_bases: int, pad_multiple: int) -> int:
    """Flattened device length for a batch of total_bases: room for the
    16-base wire tail, rounded up to the pad granularity."""
    return -(-(int(total_bases) + 16) // pad_multiple) * pad_multiple


def compact_keys(words, keep_np: np.ndarray) -> np.ndarray:
    """Stack per-word device outputs into (M, W) host keys at kept slots."""
    return np.stack([np.asarray(w)[keep_np] for w in words], axis=-1)


def host_histogram(counts: np.ndarray, upper: int) -> np.ndarray:
    """hist[c] = number of kept kmers with frequency c (c in [0, upper])."""
    return np.bincount(
        np.asarray(counts, dtype=np.int64), minlength=upper + 1
    ).astype(np.int32)[: upper + 1]


def count_flat(
    codes: np.ndarray, valid: np.ndarray, cfg: KmerConfig
) -> tuple[KmerList, np.ndarray]:
    """Count canonical k-mers of a flat device batch. Returns (list, histogram)."""
    keys, cnt, keep = _count_device(
        jnp.asarray(codes, dtype=jnp.int8),
        jnp.asarray(valid),
        cfg.k,
        cfg.lower,
        cfg.upper,
    )
    keep_np = np.asarray(keep)
    kmerlist = KmerList(
        keys=compact_keys(keys, keep_np),
        counts=np.asarray(cnt)[keep_np],
        k=cfg.k,
    )
    return kmerlist, host_histogram(kmerlist.counts, cfg.upper)


def count_reads(
    codes: np.ndarray,
    lengths: np.ndarray,
    cfg: KmerConfig,
) -> tuple[KmerList, np.ndarray]:
    """Full single-device pipeline from packed host reads.

    Feeds the device over the 2-bit packed wire (io/supermer.pack_codes_2bit
    -> ops/wire.decode_block): ~2 bits/base + 4 B/read H2D instead of
    9 bits/base for (int8 codes, bool valid) — same density the sharded and
    multihost paths already use."""
    from .io import supermer as supermer_io

    total = int(codes.size)
    n = flat_size(total, cfg.pad_multiple)
    buf = np.zeros(n, dtype=np.int8)
    buf[:total] = codes
    packed = supermer_io.pack_codes_2bit(buf)
    args = (
        jnp.asarray(packed),
        jnp.asarray(lengths.astype(np.int32)),
        cfg.k,
        n,
        cfg.lower,
        cfg.upper,
    )
    if cfg.device_compact:
        keys, cnt, n_kept = _count_device_packed_compact(*args)
        nk = int(jax.device_get(n_kept))
        kmerlist = KmerList(
            keys=np.stack(pull_prefix(list(keys), nk), axis=-1),
            counts=pull_prefix([narrow_counts(cnt, cfg.upper)], nk)[0]
            .astype(np.int32),
            k=cfg.k,
        )
    else:
        keys, cnt, keep = _count_device_packed(*args)
        keep_np = np.asarray(keep)
        kmerlist = KmerList(
            keys=compact_keys(keys, keep_np),
            counts=np.asarray(cnt)[keep_np],
            k=cfg.k,
        )
    return kmerlist, host_histogram(kmerlist.counts, cfg.upper)
