"""Supermer-routed sharded pipeline: the reference's exchange architecture.

The reference never moves raw k-mer keys between ranks — it routes
*supermers* (maximal runs of consecutive k-mers sharing a minimizer bucket,
shipped as a lengths array + 2-bit packed bases, ~0.28 B/base) and each rank
extracts + counts the k-mers it received locally (prepare_supermer
src/kmerops.cpp:23-127, SupermerEncoder :1096-1148, exchange :587-643,
receive-side parse :484-521). This module is the device form of that
architecture: the host computes per-k-mer destinations with the minimizer
scan (on the CPU backend of the SAME jitted scan the device pipelines use)
and encodes per-shard supermer run streams (io/supermer). Two transports:
single-host, every shard is fed ONLY its own buckets' supermers over the
2-bit wire and the device step needs NO all_to_all (count_reads_supermer);
across hosts, per-(src device, dst shard) segments cross the fabric in ONE
all_to_all at supermer density and the owner decodes on device
(count_reads_supermer_exchange). Either way keys never travel and the
per-shard result sets are disjoint by construction (equal canonical k-mers
share their minimizer, hence their bucket and shard).

When to use it: the wire here IS the reference's format (~2 bits/base +
4 B/supermer). Inside one host the range pipeline's key exchange needs no
encode (see docs/dcn_wire.md); over a host hop — feeding remote shards from a reader
process, spill/restore, cross-host dispatch — this path moves ~10x fewer
bytes per k-mer than packed keys.

Load balance mirrors the reference: buckets = shards * avg_buckets_per_shard
virtual tasks, placed by the balanced dispatcher from exact host-side bucket
sizes (BalancedDispatcher, src/kmerops.cpp:1274-1327). Capacity needs no
guessing and no retry: every shard's exact base/supermer totals are known
before the device step is traced.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..config import KmerConfig
from ..ops import kmer as kmer_ops, sort as sort_ops
from .mesh import SHARD_AXIS, make_mesh
from .pipeline import _count_merged

__all__ = [
    "count_reads_supermer",
    "count_reads_supermer_ext",
    "count_reads_supermer_exchange",
    "count_reads_supermer_streaming",
    "count_fasta_multihost_supermer_streaming",
    "count_fasta_multihost_supermer",
    "host_destinations",
    "wire_nbytes",
]


def host_destinations(
    codes: np.ndarray, k: int, m: int, num_buckets: int
) -> np.ndarray:
    """Per-k-mer destination buckets, computed host-side on the CPU backend.

    Runs the SAME jitted minimizer scan the device pipelines use
    (ops/minimizer.kmer_destinations) — one implementation of the routing
    rule, two execution targets. XLA:CPU vectorizes the scan (elementwise
    mixes + log2(window) min-rolls) at memory bandwidth, standing in for
    the reference's OpenMP FindKmerDestinationsParallel
    (src/kmerops.cpp:1010-1041).
    """
    from jax.sharding import SingleDeviceSharding

    from ..ops import minimizer as minimizer_ops

    # Pin input AND output to this process's first CPU device: under
    # jax.distributed an unpinned jit replicates over every process's
    # devices and its output cannot be fetched locally.
    cpu = jax.local_devices(backend="cpu")[0]
    sd = SingleDeviceSharding(cpu)
    dest = jax.jit(
        minimizer_ops.kmer_destinations,
        static_argnums=(1, 2, 3),
        out_shardings=sd,
    )(jax.device_put(jnp.asarray(codes, dtype=jnp.int32), sd),
      k, m, num_buckets)
    return np.asarray(jax.device_get(dest))


def host_canonical_words(codes: np.ndarray, k: int) -> list[np.ndarray]:
    """Per-position canonical key words, computed on the CPU backend with
    the SAME jitted builder the device pipelines use (one routing/keying
    rule, two execution targets — the host_destinations pattern)."""
    from jax.sharding import SingleDeviceSharding

    cpu = jax.local_devices(backend="cpu")[0]
    sd = SingleDeviceSharding(cpu)
    words = jax.jit(
        lambda c: tuple(kmer_ops.canonical_words(c.astype(jnp.int32), k)),
        static_argnums=(), out_shardings=sd,
    )(jax.device_put(codes, sd))
    return [np.asarray(jax.device_get(w)) for w in words]


def heavy_precount(
    flat_codes: np.ndarray,
    flat_valid: np.ndarray,
    dest: np.ndarray,
    types: np.ndarray,
    assign: np.ndarray,
    k: int,
    num_shards: int,
) -> tuple[np.ndarray, list[tuple[np.ndarray, np.ndarray]]]:
    """Convert heavy buckets' k-mers to pre-counted (key, cnt) entries.

    The device form of the reference's heavy-task conversion to a
    ScatteredKmerList (src/kmerops.cpp:363-417): k-mers of HEAVY buckets
    are stripped from the raw supermer streams (returned valid mask) and
    counted host-side into per-owner-shard sorted (keys, cnts) lists.
    Because classification is per BUCKET and equal canonical k-mers share
    their bucket, the entry key set is DISJOINT from everything the
    devices count — entries never need to touch the wire or the device at
    all; they filter and append host-side (one-shot) or join the final
    partial merge as an extra sorted run (streaming).

    Returns (valid_without_heavy, [(keys (E,W) ascending, cnts int64)] per
    shard).
    """
    heavy_pos = flat_valid.astype(bool) & (types[dest] == 1)
    new_valid = flat_valid & ~heavy_pos
    pos = np.flatnonzero(heavy_pos)
    words = host_canonical_words(flat_codes, k)
    keys = np.stack([w[pos] for w in words], axis=-1)
    owner = assign[dest[pos]]
    per_shard: list[tuple[np.ndarray, np.ndarray]] = []
    w = keys.shape[1] if keys.size else len(words)
    for s in range(num_shards):
        ks = keys[owner == s]
        if ks.shape[0] == 0:
            per_shard.append(
                (np.zeros((0, w), np.uint32), np.zeros(0, np.int64))
            )
            continue
        uk, cnts = np.unique(ks, axis=0, return_counts=True)
        per_shard.append((uk.astype(np.uint32), cnts.astype(np.int64)))
    return new_valid, per_shard


def _sum_entry_lists(
    lists: list[tuple[np.ndarray, np.ndarray]]
) -> tuple[np.ndarray, np.ndarray]:
    """Sum counts of possibly-repeating keys across entry lists (one per
    contributing host/batch) into one ascending (keys, cnts)."""
    ks = [k for k, _ in lists if k.shape[0]]
    if not ks:
        w = lists[0][0].shape[1] if lists else 1
        return np.zeros((0, w), np.uint32), np.zeros(0, np.int64)
    allk = np.concatenate(ks)
    allc = np.concatenate([c for _, c in lists if c.shape[0]])
    uk, inv = np.unique(allk, axis=0, return_inverse=True)
    sums = np.zeros(uk.shape[0], dtype=np.int64)
    np.add.at(sums, inv.reshape(-1), allc.astype(np.int64))
    return uk.astype(np.uint32), sums


def _allgather_entry_lists(
    per_shard: list[tuple[np.ndarray, np.ndarray]]
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Sum each shard's heavy entries across processes (padded allgather
    of the tiny per-shard lists; counts > 0 marks real rows)."""
    from jax.experimental import multihost_utils

    S = len(per_shard)
    w = per_shard[0][0].shape[1]
    emax_local = max((k.shape[0] for k, _ in per_shard), default=0)
    emax = int(
        multihost_utils.process_allgather(np.asarray(emax_local)).max()
    )
    emax = max(emax, 1)
    keys_p = np.zeros((S, emax, w), np.uint32)
    cnts_p = np.zeros((S, emax), np.int64)
    for s, (ks, cs) in enumerate(per_shard):
        keys_p[s, : ks.shape[0]] = ks
        cnts_p[s, : cs.shape[0]] = cs
    gk = multihost_utils.process_allgather(keys_p)
    gc = multihost_utils.process_allgather(cnts_p)
    out = []
    for s in range(S):
        lists = [
            (gk[p, s][gc[p, s] > 0], gc[p, s][gc[p, s] > 0])
            for p in range(gk.shape[0])
        ]
        out.append(_sum_entry_lists(lists))
    return out


def _append_heavy_entries(
    kmerlist, entries: tuple[np.ndarray, np.ndarray], cfg: KmerConfig
):
    """Filter summed heavy entries by [L,U] and append to a KmerList
    (host-side; the entry key set is disjoint from the device's)."""
    from ..pipeline import KmerList

    uk, cnts = entries
    keep = (cnts >= cfg.lower) & (cnts <= cfg.upper)
    if not keep.any():
        return kmerlist
    return KmerList(
        keys=np.concatenate([kmerlist.keys, uk[keep]]),
        counts=np.concatenate(
            [kmerlist.counts,
             cnts[keep].astype(kmerlist.counts.dtype)]
        ),
        k=cfg.k,
    )


def _pack_streams(
    streams: list[tuple[np.ndarray, np.ndarray]],
    pad_multiple: int,
    min_block_len: int = 0,
    min_lmax: int = 1,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Per-shard (codes, lengths) streams -> wire arrays of one common shape.

    Returns (packed (S*block_len/16,) uint32, lengths2d (S, lmax) int32,
    block_len). Same wire layout as pipeline.distribute_reads_packed; the
    +16 tail keeps the sliding packers off meaningful data. min_block_len /
    min_lmax let the streaming loop hold one compiled shape across batches.
    """
    from ..io import supermer as supermer_io

    num_shards = len(streams)
    gran = int(np.lcm(16, pad_multiple))
    raw = max(max(c.shape[0] for c, _ in streams) + 16, gran, min_block_len)
    block_len = -(-raw // gran) * gran
    lmax = max(max(l.shape[0] for _, l in streams), 1, min_lmax)

    packed = np.zeros((num_shards, block_len // 16), dtype=np.uint32)
    lens2d = np.zeros((num_shards, lmax), dtype=np.int32)
    for s, (c, l) in enumerate(streams):
        buf = np.zeros(block_len, dtype=np.int8)
        buf[: c.shape[0]] = c
        packed[s] = supermer_io.pack_codes_2bit(buf)
        lens2d[s, : l.shape[0]] = l
    return packed.reshape(-1), lens2d, block_len


def wire_nbytes(streams: list[tuple[np.ndarray, ...]]) -> int:
    """Exchange bytes this dispatch ships: 2 bits/base + 4 B/supermer
    (+8 B/supermer of {rid0, pos0} headers for EXT streams)."""
    return sum(
        -(-int(s[0].shape[0]) // 4) + sum(int(a.nbytes) for a in s[1:])
        for s in streams
    )


@functools.partial(
    jax.jit, static_argnames=("cfg", "num_shards", "block_len", "mesh")
)
def _count_supermer_jit(packed, lengths, *, cfg, num_shards, block_len, mesh):
    """Per-shard local count over received supermers — no collective in the
    body: routing already happened at the (host) supermer dispatch, the
    device analogue of the reference's post-exchange process_tasks
    (src/kmerops.cpp:851-872): sort_task + count_sorted_kmers per shard."""
    from ..ops import wire

    def body(pk, ln):
        codes, valid = wire.decode_block(pk, ln, cfg.k, block_len)
        words = kmer_ops.canonical_words(codes.astype(jnp.int32), cfg.k)
        marked = sort_ops.apply_sentinel(~valid, words)
        _, words_s, _ = sort_ops.sort_marked(marked)
        cnt, keep = _count_merged(words_s, cfg)
        return tuple(words_s), cnt, keep

    word_specs = tuple(P(SHARD_AXIS) for _ in range(cfg.words))
    return shard_map(
        body,
        mesh=mesh,
        in_specs=(P(SHARD_AXIS), P(SHARD_AXIS)),
        out_specs=(word_specs, P(SHARD_AXIS), P(SHARD_AXIS)),
        check_vma=False,
    )(packed, lengths)


def count_reads_supermer(
    codes: np.ndarray,
    lengths: np.ndarray,
    cfg: KmerConfig,
    mesh: Optional[Mesh] = None,
):
    """Supermer-dispatch entry: raw (codes, read lengths) -> (KmerList, hist).

    Pipeline: host minimizer scan -> balanced bucket dispatch -> per-shard
    supermer run streams -> 2-bit wire -> per-shard local sort+count.
    Output semantics identical to every other entry point.
    """
    from ..io import fasta as fasta_io, supermer as supermer_io
    from ..pipeline import KmerList, compact_keys, host_histogram
    from . import dispatch

    assert cfg.routing == "supermer", cfg.routing
    if cfg.extension:
        return count_reads_supermer_ext(codes, lengths, cfg, mesh)
    mesh = mesh or make_mesh()
    num_shards = mesh.devices.size

    flat_codes, flat_valid = fasta_io.flatten_for_device(
        codes, lengths, cfg.k, cfg.pad_multiple
    )
    num_buckets = num_shards * cfg.avg_buckets_per_shard
    dest = host_destinations(flat_codes, cfg.k, cfg.m, num_buckets)

    sizes = np.bincount(
        dest[flat_valid.astype(bool)], minlength=num_buckets
    ).astype(np.int64)
    # Heavy-hitter pre-count: a dominant bucket otherwise inflates the
    # padded per-shard block for EVERY shard and ships all its duplicates
    # raw. Classified buckets leave
    # the streams entirely; their sizes drop out of the dispatch load.
    types = np.zeros(num_buckets, np.int32)
    if cfg.classifier == "heavy_hitter":
        types = dispatch.classify(sizes, cfg.heavy_ratio)
    dispatch_sizes = np.where(types == dispatch.HEAVY, 0, sizes)
    if cfg.dispatcher == "balanced":
        assign = dispatch.balanced_assignment(dispatch_sizes, num_shards)
    else:
        assign = dispatch.round_robin_assignment(num_buckets, num_shards)

    heavy_entries = None
    if (types == dispatch.HEAVY).any():
        flat_valid, per_shard = heavy_precount(
            flat_codes, flat_valid, dest, types, assign, cfg.k, num_shards
        )
        heavy_entries = _sum_entry_lists(per_shard)
    shard_of = assign[dest]

    streams = supermer_io.encode_supermer_streams(
        flat_codes, flat_valid, shard_of, cfg.k, num_shards
    )
    packed, lens2d, block_len = _pack_streams(streams, cfg.pad_multiple)

    keys, cnt, keep = _count_supermer_jit(
        jnp.asarray(packed),
        jnp.asarray(lens2d),
        cfg=cfg,
        num_shards=num_shards,
        block_len=block_len,
        mesh=mesh,
    )

    keep_np = np.asarray(keep)
    kmerlist = KmerList(
        keys=compact_keys(keys, keep_np),
        counts=np.asarray(cnt)[keep_np],
        k=cfg.k,
    )
    if heavy_entries is not None:
        kmerlist = _append_heavy_entries(kmerlist, heavy_entries, cfg)
    return kmerlist, host_histogram(kmerlist.counts, cfg.upper)


def count_reads_supermer_streaming(
    codes: np.ndarray,
    lengths: np.ndarray,
    cfg: KmerConfig,
    batch_bases: int = 1 << 26,
    mesh: Optional[Mesh] = None,
    async_depth: Optional[int] = None,
):
    """Bounded-memory supermer-routed counting: device batches of
    batch_bases stream through the host dispatch + local count, UNFILTERED
    per-batch (key, count) partials accumulate per shard, and one final
    merge pass sums them under the [L,U] filter — the supermer analogue of
    count_reads_sharded_streaming and of the reference's fixed-size
    supermer rounds (src/kmerops.cpp:587-643). Keys never change owner
    across batches: the bucket->shard assignment is fixed on batch 0.

    Heavy buckets (classifier) are pre-counted host-side per batch; their
    summed entries enter the final merge as one extra sorted run per shard,
    so even classification decisions that differ between batches stay
    exact. Up to `async_depth` batches stay in flight (jit dispatch is
    asynchronous); results are depth-independent (FIFO settle).

    EXT mode delegates to the generic EXT streaming wrapper (per-batch
    unfiltered supermer EXT pass + host occurrence-partial merge).
    """
    from ..io import fasta as fasta_io, supermer as supermer_io
    from ..pipeline import KmerList, compact_keys, host_histogram
    from ..runtime.scheduler import iter_read_batches
    from . import dispatch
    from .pipeline import (
        _merge_partials_jit, _next_pow2,
    )
    import dataclasses

    assert cfg.routing == "supermer", cfg.routing
    if cfg.extension:
        from .pipeline import count_reads_sharded_ext_streaming

        return count_reads_sharded_ext_streaming(
            codes, lengths, cfg, batch_bases, mesh
        )
    mesh = mesh or make_mesh()
    num_shards = mesh.devices.size
    num_buckets = num_shards * cfg.avg_buckets_per_shard
    w = cfg.words
    if async_depth is None:
        from ..runtime.scheduler import suggest_pipe_depth

        async_depth = suggest_pipe_depth(
            batch_bases, cfg.words, max_depth=4
        )

    partial_k: list[list[np.ndarray]] = [[] for _ in range(num_shards)]
    partial_c: list[list[np.ndarray]] = [[] for _ in range(num_shards)]
    heavy_lists: list[list[tuple[np.ndarray, np.ndarray]]] = [
        [] for _ in range(num_shards)
    ]
    assign = None
    cfg2 = None
    target_block = 0
    target_lmax = 1
    pending: list[tuple] = []

    def _settle(outs) -> None:
        keys, cnt, keep = outs
        keep_np = np.asarray(keep)
        cnt_np = np.asarray(cnt)
        words_np = [np.asarray(x) for x in keys]
        out_len = keep_np.shape[0] // num_shards
        for s in range(num_shards):
            sl = slice(s * out_len, (s + 1) * out_len)
            km = keep_np[sl]
            partial_k[s].append(
                np.stack([x[sl][km] for x in words_np], axis=-1)
            )
            partial_c[s].append(cnt_np[sl][km].astype(np.uint32))

    for b_codes, b_lengths in iter_read_batches(codes, lengths, batch_bases):
        flat_codes, flat_valid = fasta_io.flatten_for_device(
            b_codes, b_lengths, cfg.k, cfg.pad_multiple
        )
        dest = host_destinations(flat_codes, cfg.k, cfg.m, num_buckets)
        sizes = np.bincount(
            dest[flat_valid.astype(bool)], minlength=num_buckets
        ).astype(np.int64)
        types = np.zeros(num_buckets, np.int32)
        if cfg.classifier == "heavy_hitter":
            types = dispatch.classify(sizes, cfg.heavy_ratio)
        if assign is None:
            dispatch_sizes = np.where(types == dispatch.HEAVY, 0, sizes)
            if cfg.dispatcher == "balanced":
                assign = dispatch.balanced_assignment(
                    dispatch_sizes, num_shards
                )
            else:
                assign = dispatch.round_robin_assignment(
                    num_buckets, num_shards
                )
        if (types == dispatch.HEAVY).any():
            flat_valid, per_shard = heavy_precount(
                flat_codes, flat_valid, dest, types, assign, cfg.k,
                num_shards,
            )
            for s in range(num_shards):
                if per_shard[s][0].shape[0]:
                    heavy_lists[s].append(per_shard[s])
        shard_of = assign[dest]
        streams = supermer_io.encode_supermer_streams(
            flat_codes, flat_valid, shard_of, cfg.k, num_shards
        )
        packed, lens2d, block_len = _pack_streams(
            streams, cfg.pad_multiple, min_block_len=target_block,
            min_lmax=target_lmax,
        )
        target_block = max(target_block, block_len)
        target_lmax = max(target_lmax, lens2d.shape[1])
        if cfg2 is None:
            cfg2 = dataclasses.replace(cfg, unfiltered=True)
        outs = _count_supermer_jit(
            jnp.asarray(packed), jnp.asarray(lens2d),
            cfg=cfg2, num_shards=num_shards, block_len=block_len,
            mesh=mesh,
        )
        pending.append(outs)
        if len(pending) >= max(async_depth, 1):
            _settle(pending.pop(0))
    while pending:
        _settle(pending.pop(0))

    if assign is None:
        empty = KmerList(
            np.zeros((0, w), np.uint32), np.zeros(0, np.int32), cfg.k
        )
        return empty, host_histogram(empty.counts, cfg.upper)

    # Heavy entries join the final merge as one extra sorted run per shard
    # (counts sum with any raw partials from batches where the same bucket
    # classified NORMAL).
    for s in range(num_shards):
        if heavy_lists[s]:
            uk, cnts = _sum_entry_lists(heavy_lists[s])
            partial_k[s].append(uk)
            partial_c[s].append(cnts.astype(np.uint32))

    n_runs = _next_pow2(max(max(len(pk) for pk in partial_k), 1))
    run_len = _next_pow2(
        max(
            max((a.shape[0] for pk in partial_k for a in pk), default=1), 1
        )
    )
    all_k = np.full(
        (num_shards, n_runs, run_len, w), 0xFFFFFFFF, dtype=np.uint32
    )
    all_c = np.zeros((num_shards, n_runs, run_len), dtype=np.uint32)
    for s in range(num_shards):
        for b, (ks, cs) in enumerate(zip(partial_k[s], partial_c[s])):
            all_k[s, b, : ks.shape[0]] = ks
            all_c[s, b, : cs.shape[0]] = cs
    words_in = tuple(
        jnp.asarray(all_k[:, :, :, i].reshape(-1)) for i in range(w)
    )
    keys_s, total, keep = _merge_partials_jit(
        words_in, jnp.asarray(all_c.reshape(-1)),
        cfg=cfg, num_shards=num_shards, run_len=run_len, mesh=mesh,
    )
    keep_np = np.asarray(keep)
    kmerlist = KmerList(
        keys=compact_keys(keys_s, keep_np),
        counts=np.asarray(total)[keep_np],
        k=cfg.k,
    )
    return kmerlist, host_histogram(kmerlist.counts, cfg.upper)


# ---------------------------------------------------------------------------
# Device-exchange variant: supermers travel the device interconnect.
#
# The single-host path above can hand every shard its buckets directly
# (the host addresses all devices). Across HOSTS it cannot — a process only
# feeds its own devices — so the supermer streams themselves must cross the
# interconnect. This is the reference's exchange verbatim in device terms:
# every source device holds one supermer segment (lengths + 2-bit words)
# per destination shard, ONE all_to_all swaps them (cross-host edges ride
# the network at ~2 bits/base; see docs/dcn_wire.md), and the owner shard parses the received segments
# on device (ops/wire.decode, the receive-side parse of
# src/kmerops.cpp:484-521) before the same local sort + count.
# ---------------------------------------------------------------------------


def split_stream(
    c: np.ndarray, ln: np.ndarray, parts: int, *extras: np.ndarray
) -> list[tuple[np.ndarray, ...]]:
    """Split one (codes, lengths, *per-run extras) stream into `parts`
    contiguous sub-streams on supermer boundaries, balanced by bases."""
    if parts == 1:
        return [(c, ln, *extras)]
    bases_end = np.cumsum(ln.astype(np.int64))
    total = int(bases_end[-1]) if ln.size else 0
    # First supermer index of each part: balanced prefix targets.
    cuts = np.searchsorted(
        bases_end, np.arange(1, parts) * (total / parts), side="left"
    )
    bounds = np.concatenate([[0], cuts, [ln.size]])
    base_bounds = np.concatenate([[0], bases_end])[bounds]
    return [
        (
            c[base_bounds[i] : base_bounds[i + 1]],
            ln[bounds[i] : bounds[i + 1]],
            *(e[bounds[i] : bounds[i + 1]] for e in extras),
        )
        for i in range(parts)
    ]


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "num_shards", "block_len", "lmax", "mesh"),
)
def _exchange_count_supermer_jit(
    packed, lengths, *, cfg, num_shards, block_len, lmax, mesh
):
    """Per-device (num_shards, block) supermer segments -> all_to_all ->
    receive-side decode -> local sort + count."""
    from ..ops import wire

    def body(pk, ln):
        pk = pk.reshape(num_shards, block_len // 16)
        ln = ln.reshape(num_shards, lmax)
        a2a = lambda x: jax.lax.all_to_all(
            x, SHARD_AXIS, split_axis=0, concat_axis=0, tiled=True
        )
        rpk, rln = a2a(pk), a2a(ln)
        # Unpacking is position-independent and segments start on word
        # boundaries: one flat unpack covers all received segments.
        codes = wire.unpack_codes(
            rpk.reshape(-1), num_shards * block_len
        )
        valid = jnp.concatenate(
            [
                wire.valid_from_lengths(rln[i], cfg.k, block_len)
                for i in range(num_shards)
            ]
        )
        words = kmer_ops.canonical_words(codes.astype(jnp.int32), cfg.k)
        marked = sort_ops.apply_sentinel(~valid, words)
        _, words_s, _ = sort_ops.sort_marked(marked)
        cnt, keep = _count_merged(words_s, cfg)
        return tuple(words_s), cnt, keep

    word_specs = tuple(P(SHARD_AXIS) for _ in range(cfg.words))
    return shard_map(
        body,
        mesh=mesh,
        in_specs=(P(SHARD_AXIS), P(SHARD_AXIS)),
        out_specs=(word_specs, P(SHARD_AXIS), P(SHARD_AXIS)),
        check_vma=False,
    )(packed, lengths)


def _prepare_exchange_arrays(
    flat_codes, flat_valid, shard_of, lengths, read_id_offset,
    cfg: KmerConfig, num_shards: int, n_local: int, multiproc: bool,
    ext: bool, min_block_len: int = 0, min_lmax: int = 1,
):
    """Encode this host's supermer streams and lay them out as the
    (src local device, dst shard) exchange segments of one common shape.
    Returns (packed, lens, rid0, pos0, block_len, lmax); block_len/lmax
    are allgathered so the collective shape agrees across hosts, and
    min_block_len/min_lmax let a streaming loop hold one compiled shape
    across batches (grow-only)."""
    from ..io import supermer as supermer_io

    if ext:
        streams = supermer_io.encode_supermer_streams_ext(
            flat_codes, flat_valid, shard_of, cfg.k, num_shards,
            lengths, read_id_offset,
        )
    else:
        streams = supermer_io.encode_supermer_streams(
            flat_codes, flat_valid, shard_of, cfg.k, num_shards
        )
    # Segment (src local device, dst shard): this host's per-dst stream
    # split across its local devices on supermer boundaries.
    segs = [[None] * num_shards for _ in range(n_local)]
    for s, stream in enumerate(streams):
        for d, sub in enumerate(split_stream(*stream[:2], n_local,
                                             *stream[2:])):
            segs[d][s] = sub

    cmax = max(
        (sub[0].shape[0] for row in segs for sub in row), default=0
    )
    smax = max(
        (sub[1].shape[0] for row in segs for sub in row), default=0
    )
    gran = int(np.lcm(16, cfg.pad_multiple))
    if multiproc:
        from jax.experimental import multihost_utils

        dims = multihost_utils.process_allgather(
            np.asarray([cmax, smax], dtype=np.int64)
        )
        cmax, smax = int(dims[:, 0].max()), int(dims[:, 1].max())
    block_len = -(-max(cmax + 16, gran, min_block_len) // gran) * gran
    lmax = max(smax, 1, min_lmax)

    packed = np.zeros(
        (n_local, num_shards, block_len // 16), dtype=np.uint32
    )
    lens = np.zeros((n_local, num_shards, lmax), dtype=np.int32)
    rid0 = np.zeros((n_local, num_shards, lmax), dtype=np.int32)
    pos0 = np.zeros((n_local, num_shards, lmax), dtype=np.uint32)
    for d in range(n_local):
        for s in range(num_shards):
            c, ln = segs[d][s][:2]
            buf = np.zeros(block_len, dtype=np.int8)
            buf[: c.shape[0]] = c
            packed[d, s] = supermer_io.pack_codes_2bit(buf)
            lens[d, s, : ln.shape[0]] = ln
            if ext:
                r, p = segs[d][s][2:]
                rid0[d, s, : r.shape[0]] = r
                pos0[d, s, : p.shape[0]] = p
    return packed, lens, rid0, pos0, block_len, lmax


def count_reads_supermer_exchange(
    codes: np.ndarray,
    lengths: np.ndarray,
    cfg: KmerConfig,
    mesh: Optional[Mesh] = None,
    read_id_offset: int = 0,
):
    """Supermer pipeline with the on-fabric exchange. Works at any process
    count: single-process it is an equality twin of count_reads_supermer
    (useful on CPU meshes and for the smoke tests); multi-process it is THE
    path — each host routes only through its own devices and the supermer
    wire crosses hosts inside the all_to_all. In EXT mode segments carry
    the reference's {len, pos, rid} run headers (include/kmer.hpp:348-360)
    and the owner shard derives per-k-mer payloads after the exchange.

    Returns (this process's KmerList[Ext] shard, global histogram).
    """
    from ..io import fasta as fasta_io, supermer as supermer_io
    from ..pipeline import KmerList, compact_keys
    from . import dispatch, multihost

    ext = cfg.extension
    mesh = mesh or Mesh(np.asarray(jax.devices()), (SHARD_AXIS,))
    num_shards = mesh.devices.size
    pidx = jax.process_index()
    local_devs = [d for d in mesh.devices.flat if d.process_index == pidx]
    n_local = len(local_devs)
    multiproc = jax.process_count() > 1

    flat_codes, flat_valid = fasta_io.flatten_for_device(
        codes, lengths, cfg.k, cfg.pad_multiple
    )
    num_buckets = num_shards * cfg.avg_buckets_per_shard
    dest = host_destinations(flat_codes, cfg.k, cfg.m, num_buckets)

    sizes = np.bincount(
        dest[flat_valid.astype(bool)], minlength=num_buckets
    ).astype(np.int64)
    if multiproc:
        from jax.experimental import multihost_utils

        sizes = np.asarray(
            multihost_utils.process_allgather(sizes).sum(axis=0),
            dtype=np.int64,
        )
    types = np.zeros(num_buckets, np.int32)
    if cfg.classifier == "heavy_hitter" and not ext:
        types = dispatch.classify(sizes, cfg.heavy_ratio)
    dispatch_sizes = np.where(types == dispatch.HEAVY, 0, sizes)
    if cfg.dispatcher == "balanced":
        assign = dispatch.balanced_assignment(dispatch_sizes, num_shards)
    else:
        assign = dispatch.round_robin_assignment(num_buckets, num_shards)

    heavy_per_shard = None
    if (types == dispatch.HEAVY).any():
        # Each host pre-counts ITS heavy k-mers; entries sum across hosts
        # below (they are partial counts of the same disjoint key set).
        flat_valid, heavy_per_shard = heavy_precount(
            flat_codes, flat_valid, dest, types, assign, cfg.k, num_shards
        )
        if multiproc:
            heavy_per_shard = _allgather_entry_lists(heavy_per_shard)
    shard_of = assign[dest]

    packed, lens, rid0, pos0, block_len, lmax = _prepare_exchange_arrays(
        flat_codes, flat_valid, shard_of, lengths, read_id_offset,
        cfg, num_shards, n_local, multiproc, ext,
    )


    def globalize(arr):
        if not multiproc:
            return jnp.asarray(arr.reshape(-1))
        from jax.sharding import NamedSharding

        sharding = NamedSharding(mesh, P(SHARD_AXIS))
        flat = np.ascontiguousarray(arr.reshape(-1))
        return jax.make_array_from_process_local_data(
            sharding, flat, (num_shards * flat.size // n_local,)
        )

    if ext:
        keys, cnt, keep, srid, spos = _exchange_count_supermer_ext_jit(
            globalize(packed), globalize(lens), globalize(rid0),
            globalize(pos0),
            cfg=cfg, num_shards=num_shards, block_len=block_len,
            lmax=lmax, mesh=mesh,
        )
        return _assemble_ext(
            keys, cnt, keep, srid, spos, cfg, multiproc
        )

    keys, cnt, keep = _exchange_count_supermer_jit(
        globalize(packed), globalize(lens),
        cfg=cfg, num_shards=num_shards, block_len=block_len, lmax=lmax,
        mesh=mesh,
    )

    if multiproc:
        kmerlist = multihost._gather_kmerlist(
            keys, cnt, keep, cfg, unmix=False
        )
        if heavy_per_shard is not None:
            local_shards = [
                i for i, d in enumerate(mesh.devices.flat)
                if d.process_index == pidx
            ]
            kmerlist = _append_heavy_entries(
                kmerlist,
                _sum_entry_lists(
                    [heavy_per_shard[s] for s in local_shards]
                ),
                cfg,
            )
        hist = multihost._global_histogram(kmerlist.counts, cfg.upper)
        return kmerlist, hist
    from ..pipeline import host_histogram

    keep_np = np.asarray(keep)
    kmerlist = KmerList(
        keys=compact_keys(keys, keep_np),
        counts=np.asarray(cnt)[keep_np],
        k=cfg.k,
    )
    if heavy_per_shard is not None:
        kmerlist = _append_heavy_entries(
            kmerlist, _sum_entry_lists(heavy_per_shard), cfg
        )
    return kmerlist, host_histogram(kmerlist.counts, cfg.upper)


def count_fasta_multihost_supermer_streaming(
    fasta_path: str, cfg: KmerConfig, batch_bases: int = 1 << 26
):
    """Bounded-memory multi-process supermer counting: every host streams
    its read shard through the on-fabric supermer exchange in device
    batches of batch_bases — the direct device form of the reference's
    fixed-size supermer rounds across ranks (src/kmerops.cpp:587-643).
    UNFILTERED per-batch partials accumulate per local device shard (the
    batch-0 bucket assignment fixes key ownership) and one final
    collective merge applies [L,U]. Heavy buckets pre-count host-side per
    batch and join the final merge as one extra sorted run per shard.
    """
    import dataclasses

    from jax.sharding import NamedSharding
    from ..io import fasta as fasta_io
    from . import dispatch, multihost
    from . import pipeline as shard_pipeline

    assert cfg.routing == "supermer", cfg.routing
    if cfg.extension:
        return _multihost_supermer_ext_streaming(fasta_path, cfg, batch_bases)
    codes, lengths = multihost.read_my_shard(fasta_path, cfg)
    mesh = Mesh(np.asarray(jax.devices()), (SHARD_AXIS,))
    num_shards = mesh.devices.size
    pidx = jax.process_index()
    local_idx = [
        i for i, d in enumerate(mesh.devices.flat)
        if d.process_index == pidx
    ]
    n_local = len(local_idx)
    multiproc = jax.process_count() > 1
    num_buckets = num_shards * cfg.avg_buckets_per_shard
    w = cfg.words

    spans = shard_pipeline.batch_spans(lengths, batch_bases)
    nb = len(spans)
    if multiproc:
        from jax.experimental import multihost_utils

        nb = int(multihost_utils.process_allgather(np.asarray(nb)).max())
    offsets = np.concatenate([[0], np.cumsum(lengths)])

    partial_k: list[list[np.ndarray]] = [[] for _ in range(n_local)]
    partial_c: list[list[np.ndarray]] = [[] for _ in range(n_local)]
    heavy_acc: list[list[tuple[np.ndarray, np.ndarray]]] = [
        [] for _ in range(n_local)
    ]
    assign = None
    cfg2 = None
    tblock, tlmax = 0, 1

    def globalize(arr):
        if not multiproc:
            return jnp.asarray(arr.reshape(-1))
        sharding = NamedSharding(mesh, P(SHARD_AXIS))
        flat = np.ascontiguousarray(arr.reshape(-1))
        return jax.make_array_from_process_local_data(
            sharding, flat, (num_shards * flat.size // n_local,)
        )

    for i in range(nb):
        if i < len(spans):
            s0, e0 = spans[i]
            b_codes = codes[offsets[s0]: offsets[e0]]
            b_lengths = lengths[s0:e0]
        else:
            b_codes = np.zeros(0, dtype=codes.dtype)
            b_lengths = np.zeros(0, dtype=np.int64)
        flat_codes, flat_valid = fasta_io.flatten_for_device(
            b_codes, b_lengths, cfg.k, cfg.pad_multiple
        )
        dest = host_destinations(flat_codes, cfg.k, cfg.m, num_buckets)
        sizes = np.bincount(
            dest[flat_valid.astype(bool)], minlength=num_buckets
        ).astype(np.int64)
        if multiproc:
            from jax.experimental import multihost_utils

            sizes = np.asarray(
                multihost_utils.process_allgather(sizes).sum(axis=0),
                dtype=np.int64,
            )
        types = np.zeros(num_buckets, np.int32)
        if cfg.classifier == "heavy_hitter":
            types = dispatch.classify(sizes, cfg.heavy_ratio)
        if assign is None:
            dispatch_sizes = np.where(types == dispatch.HEAVY, 0, sizes)
            if cfg.dispatcher == "balanced":
                assign = dispatch.balanced_assignment(
                    dispatch_sizes, num_shards
                )
            else:
                assign = dispatch.round_robin_assignment(
                    num_buckets, num_shards
                )
        if (types == dispatch.HEAVY).any():
            flat_valid, per_shard = heavy_precount(
                flat_codes, flat_valid, dest, types, assign, cfg.k,
                num_shards,
            )
            if multiproc:
                per_shard = _allgather_entry_lists(per_shard)
            for d, g in enumerate(local_idx):
                if per_shard[g][0].shape[0]:
                    heavy_acc[d].append(per_shard[g])
        shard_of = assign[dest]

        packed, lens, _, _, block_len, lmax = _prepare_exchange_arrays(
            flat_codes, flat_valid, shard_of, b_lengths, 0,
            cfg, num_shards, n_local, multiproc, ext=False,
            min_block_len=tblock, min_lmax=tlmax,
        )
        tblock, tlmax = max(tblock, block_len), max(tlmax, lmax)
        if cfg2 is None:
            cfg2 = dataclasses.replace(cfg, unfiltered=True)
        keys, cnt, keep = _exchange_count_supermer_jit(
            globalize(packed), globalize(lens),
            cfg=cfg2, num_shards=num_shards, block_len=block_len,
            lmax=lmax, mesh=mesh,
        )
        keep_l = multihost._local_shards(keep)
        cnt_l = multihost._local_shards(cnt)
        words_l = [multihost._local_shards(x) for x in keys]
        out_len = keep_l.shape[0] // n_local
        for d in range(n_local):
            sl = slice(d * out_len, (d + 1) * out_len)
            km = keep_l[sl]
            partial_k[d].append(
                np.stack([x[sl][km] for x in words_l], axis=-1)
            )
            partial_c[d].append(cnt_l[sl][km].astype(np.uint32))

    # Heavy entries: one extra ascending run per local shard.
    for d in range(n_local):
        if heavy_acc[d]:
            uk, cnts = _sum_entry_lists(heavy_acc[d])
            partial_k[d].append(uk)
            partial_c[d].append(cnts.astype(np.uint32))

    npart = max((len(pk) for pk in partial_k), default=1)
    run_len = max(
        (a.shape[0] for pk in partial_k for a in pk), default=1
    )
    if multiproc:
        from jax.experimental import multihost_utils

        dims = multihost_utils.process_allgather(
            np.asarray([run_len, npart])
        )
        run_len, npart = int(dims[:, 0].max()), int(dims[:, 1].max())
    run_len = shard_pipeline._next_pow2(max(run_len, 1))
    n_runs = shard_pipeline._next_pow2(max(nb, npart, 1))
    local_k = np.full(
        (n_local, n_runs, run_len, w), 0xFFFFFFFF, dtype=np.uint32
    )
    local_c = np.zeros((n_local, n_runs, run_len), dtype=np.uint32)
    for d in range(n_local):
        for b, (ks, cs) in enumerate(zip(partial_k[d], partial_c[d])):
            local_k[d, b, : ks.shape[0]] = ks
            local_c[d, b, : cs.shape[0]] = cs
    flat_len = (num_shards * n_runs * run_len,)
    sharding = NamedSharding(mesh, P(SHARD_AXIS))

    def glob_flat(arr):
        if not multiproc:
            return jnp.asarray(arr)
        return jax.make_array_from_process_local_data(
            sharding, np.ascontiguousarray(arr), flat_len
        )

    words_g = tuple(
        glob_flat(local_k[:, :, :, i].reshape(-1)) for i in range(w)
    )
    cnts_g = glob_flat(local_c.reshape(-1))
    keys_s, total, keep = shard_pipeline._merge_partials_jit(
        words_g, cnts_g,
        cfg=cfg, num_shards=num_shards, run_len=run_len, mesh=mesh,
    )
    kmerlist = multihost._gather_kmerlist(
        keys_s, total, keep, cfg, unmix=False
    )
    return kmerlist, multihost._global_histogram(
        kmerlist.counts, cfg.upper
    )


def _assemble_ext_list(keys, cnt, keep, srid, spos, cfg, multiproc):
    """Host assembly of an EXT result list (local shards under
    multi-process). No histogram — per-batch streaming partials call this
    directly so no collective runs inside the batch loop."""
    from ..pipeline import (
        KmerListExt, compact_keys, split_occurrences,
    )
    from . import multihost

    if multiproc:
        pull = multihost._local_shards
        keep_np = pull(keep)
        keys_np = np.stack([pull(w)[keep_np] for w in keys], axis=-1)
        cnt_np = pull(cnt)
        srid_np = pull(srid).astype(np.int32)
        spos_np = pull(spos).astype(np.uint32)
    else:
        keep_np = np.asarray(keep)
        keys_np = compact_keys(keys, keep_np)
        cnt_np = np.asarray(cnt)
        srid_np = np.asarray(srid).astype(np.int32)
        spos_np = np.asarray(spos).astype(np.uint32)
    starts = np.flatnonzero(keep_np)
    counts = cnt_np[starts]
    pos_runs, rid_runs = split_occurrences(
        starts, counts, spos_np, srid_np
    )
    return KmerListExt(
        keys=keys_np, counts=counts, k=cfg.k, pos=pos_runs, rid=rid_runs
    )


def _assemble_ext(keys, cnt, keep, srid, spos, cfg, multiproc):
    """Host assembly of EXT results + the global histogram."""
    from ..pipeline import host_histogram
    from . import multihost

    result = _assemble_ext_list(keys, cnt, keep, srid, spos, cfg, multiproc)
    if multiproc:
        hist = multihost._global_histogram(result.counts, cfg.upper)
    else:
        hist = host_histogram(result.counts, cfg.upper)
    return result, hist


def count_fasta_multihost_supermer(fasta_path: str, cfg: KmerConfig):
    """Multi-host supermer pipeline: per-host reads -> supermer dispatch ->
    on-fabric supermer exchange -> local count. The cross-host wire is the
    reference's supermer format (~2 bits/base + 4 B/supermer,
    src/kmerops.cpp:1096-1148) instead of W x 4 B raw keys — the ~10x
    cross-host byte reduction of docs/dcn_wire.md.
    EXT mode adds the {len, pos, rid} run headers with globally-consistent
    read ids (contiguous record partitions, like the reference's MPI_Exscan
    of read counts, src/kmerops.cpp:66)."""
    from ..io import fasta as fasta_io

    records = fasta_io.load_or_build_fai(fasta_path)
    parts = fasta_io.partition_records(records, jax.process_count())
    my_part = parts[jax.process_index()]
    rid_offset = my_part[0] if my_part else 0
    codes, lengths = fasta_io.read_records(
        fasta_path, [records[i] for i in my_part]
    )
    return count_reads_supermer_exchange(
        codes, lengths, cfg, read_id_offset=rid_offset
    )


# ---------------------------------------------------------------------------
# EXTENSION mode: the reference ships {len, pos, rid} per supermer
# (include/kmer.hpp:348-360) and extracts per-occurrence payloads on the
# receive side. Same here: the wire adds 8 B/supermer of run metadata and
# the owner shard derives every k-mer's (rid, pos) with O(n) diff-scatter
# scans (ops/wire.fill_run_meta) — never a gather.
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit, static_argnames=("cfg", "num_shards", "block_len", "mesh")
)
def _count_supermer_ext_jit(
    packed, lengths, rid0, pos0, *, cfg, num_shards, block_len, mesh
):
    from ..ops import count as count_ops, wire

    def body(pk, ln, r0, p0):
        codes, valid = wire.decode_block(pk, ln, cfg.k, block_len)
        rid, pos = wire.fill_run_meta(ln, r0, p0, block_len)
        words = kmer_ops.canonical_words(codes.astype(jnp.int32), cfg.k)
        invalid = (~valid).astype(jnp.uint32)
        inv_s, words_s, payloads_s = sort_ops.sort_keys(
            invalid, words,
            payloads=[rid.astype(jnp.uint32), pos],
        )
        svalid = inv_s == 0
        head, cnt = count_ops.run_length_count(svalid, words_s)
        lower, upper = (
            (1, 2**31 - 1) if cfg.unfiltered else (cfg.lower, cfg.upper)
        )
        keep = count_ops.frequency_filter(head, cnt, lower, upper)
        return tuple(words_s), cnt, keep, payloads_s[0], payloads_s[1]

    word_specs = tuple(P(SHARD_AXIS) for _ in range(cfg.words))
    return shard_map(
        body,
        mesh=mesh,
        in_specs=(P(SHARD_AXIS),) * 4,
        out_specs=(word_specs,) + (P(SHARD_AXIS),) * 4,
        check_vma=False,
    )(packed, lengths, rid0, pos0)


def count_reads_supermer_ext(
    codes: np.ndarray,
    lengths: np.ndarray,
    cfg: KmerConfig,
    mesh: Optional[Mesh] = None,
    read_id_offset: int = 0,
    min_dims: tuple[int, int] = (0, 1),
):
    """EXT supermer dispatch: per-kmer (rid, pos) occurrence lists with the
    run-format wire (+8 B/supermer of {rid0, pos0} headers). min_dims =
    (min_block_len, min_lmax) lets the EXT streaming wrapper hold one
    compiled shape across batches."""
    from ..io import fasta as fasta_io, supermer as supermer_io
    from ..pipeline import (
        KmerListExt, compact_keys, host_histogram, split_occurrences,
    )
    from . import dispatch

    assert cfg.extension and cfg.routing == "supermer", cfg
    mesh = mesh or make_mesh()
    num_shards = mesh.devices.size

    flat_codes, flat_valid = fasta_io.flatten_for_device(
        codes, lengths, cfg.k, cfg.pad_multiple
    )
    num_buckets = num_shards * cfg.avg_buckets_per_shard
    dest = host_destinations(flat_codes, cfg.k, cfg.m, num_buckets)
    sizes = np.bincount(
        dest[flat_valid.astype(bool)], minlength=num_buckets
    ).astype(np.int64)
    if cfg.dispatcher == "balanced":
        assign = dispatch.balanced_assignment(sizes, num_shards)
    else:
        assign = dispatch.round_robin_assignment(num_buckets, num_shards)
    shard_of = assign[dest]

    streams = supermer_io.encode_supermer_streams_ext(
        flat_codes, flat_valid, shard_of, cfg.k, num_shards,
        lengths, read_id_offset,
    )
    gran = int(np.lcm(16, cfg.pad_multiple))
    raw = max(max(c.shape[0] for c, *_ in streams) + 16, gran, min_dims[0])
    block_len = -(-raw // gran) * gran
    lmax = max(max(l.shape[0] for _, l, *_ in streams), 1, min_dims[1])

    packed = np.zeros((num_shards, block_len // 16), dtype=np.uint32)
    lens2d = np.zeros((num_shards, lmax), dtype=np.int32)
    rid2d = np.zeros((num_shards, lmax), dtype=np.int32)
    pos2d = np.zeros((num_shards, lmax), dtype=np.uint32)
    for s, (c, l, r, p) in enumerate(streams):
        buf = np.zeros(block_len, dtype=np.int8)
        buf[: c.shape[0]] = c
        packed[s] = supermer_io.pack_codes_2bit(buf)
        lens2d[s, : l.shape[0]] = l
        rid2d[s, : r.shape[0]] = r
        pos2d[s, : p.shape[0]] = p

    keys, cnt, keep, srid, spos = _count_supermer_ext_jit(
        jnp.asarray(packed.reshape(-1)),
        jnp.asarray(lens2d.reshape(-1)),
        jnp.asarray(rid2d.reshape(-1)),
        jnp.asarray(pos2d.reshape(-1)),
        cfg=cfg, num_shards=num_shards, block_len=block_len, mesh=mesh,
    )

    keep_np = np.asarray(keep)
    cnt_np = np.asarray(cnt)
    starts = np.flatnonzero(keep_np)
    counts = cnt_np[starts]
    pos_runs, rid_runs = split_occurrences(
        starts, counts,
        np.asarray(spos).astype(np.uint32),
        np.asarray(srid).astype(np.int32),
    )
    result = KmerListExt(
        keys=compact_keys(keys, keep_np),
        counts=counts,
        k=cfg.k,
        pos=pos_runs,
        rid=rid_runs,
    )
    return result, host_histogram(result.counts, cfg.upper)


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "num_shards", "block_len", "lmax", "mesh"),
)
def _exchange_count_supermer_ext_jit(
    packed, lengths, rid0, pos0, *, cfg, num_shards, block_len, lmax, mesh
):
    """EXT on-fabric exchange: the {len, rid, pos} run headers ride the same
    all_to_all as the 2-bit payload (the reference ships them inline in the
    supermer byte stream, include/kmer.hpp:348-360); the owner derives
    per-k-mer payloads with diff-scatter scans before the payload sort."""
    from ..ops import count as count_ops, wire

    def body(pk, ln, r0, p0):
        pk = pk.reshape(num_shards, block_len // 16)
        ln = ln.reshape(num_shards, lmax)
        r0 = r0.reshape(num_shards, lmax)
        p0 = p0.reshape(num_shards, lmax)
        a2a = lambda x: jax.lax.all_to_all(
            x, SHARD_AXIS, split_axis=0, concat_axis=0, tiled=True
        )
        rpk, rln, rr0, rp0 = a2a(pk), a2a(ln), a2a(r0), a2a(p0)
        codes = wire.unpack_codes(
            rpk.reshape(-1), num_shards * block_len
        )
        valids, rids, poss = [], [], []
        for i in range(num_shards):
            valids.append(
                wire.valid_from_lengths(rln[i], cfg.k, block_len)
            )
            r, p = wire.fill_run_meta(rln[i], rr0[i], rp0[i], block_len)
            rids.append(r)
            poss.append(p)
        valid = jnp.concatenate(valids)
        rid = jnp.concatenate(rids)
        pos = jnp.concatenate(poss)
        words = kmer_ops.canonical_words(codes.astype(jnp.int32), cfg.k)
        invalid = (~valid).astype(jnp.uint32)
        inv_s, words_s, payloads_s = sort_ops.sort_keys(
            invalid, words,
            payloads=[rid.astype(jnp.uint32), pos],
        )
        svalid = inv_s == 0
        head, cnt = count_ops.run_length_count(svalid, words_s)
        lower, upper = (
            (1, 2**31 - 1) if cfg.unfiltered else (cfg.lower, cfg.upper)
        )
        keep = count_ops.frequency_filter(head, cnt, lower, upper)
        return tuple(words_s), cnt, keep, payloads_s[0], payloads_s[1]

    word_specs = tuple(P(SHARD_AXIS) for _ in range(cfg.words))
    return shard_map(
        body,
        mesh=mesh,
        in_specs=(P(SHARD_AXIS),) * 4,
        out_specs=(word_specs,) + (P(SHARD_AXIS),) * 4,
        check_vma=False,
    )(packed, lengths, rid0, pos0)


def _multihost_supermer_ext_streaming(
    fasta_path: str, cfg: KmerConfig, batch_bases: int
):
    """Bounded-memory EXT supermer streaming at any process count — the
    last cell of the routing x mode x scale matrix.

    Each batch ships supermer segments WITH the reference's {len, pos, rid}
    run headers through the same all_to_all the non-EXT stream uses — the
    reference's bounded round loop is EXT-indifferent (nothing in
    src/kmerops.cpp:906-1007 conditions on EXTENSION) — counts UNFILTERED
    on the owner shard, and per-batch occurrence partials merge host-side
    under the global [L, U] (merge_ext_partials, order-free semantics).
    Read ids are globally consistent: contiguous record partitions give
    each host a base offset (the reference's MPI_Exscan of read counts,
    src/kmerops.cpp:66) and each batch adds its span start. Heavy-hitter
    classification is skipped, as in the one-shot EXT exchange: pre-counted
    entries carry no occurrence payloads.
    """
    import dataclasses

    from jax.sharding import NamedSharding
    from ..io import fasta as fasta_io
    from ..pipeline import merge_ext_partials
    from . import dispatch, multihost
    from . import pipeline as shard_pipeline

    records = fasta_io.load_or_build_fai(fasta_path)
    parts = fasta_io.partition_records(records, jax.process_count())
    my_part = parts[jax.process_index()]
    rid_offset = my_part[0] if my_part else 0
    codes, lengths = fasta_io.read_records(
        fasta_path, [records[i] for i in my_part]
    )

    mesh = Mesh(np.asarray(jax.devices()), (SHARD_AXIS,))
    num_shards = mesh.devices.size
    pidx = jax.process_index()
    n_local = len(
        [d for d in mesh.devices.flat if d.process_index == pidx]
    )
    multiproc = jax.process_count() > 1
    num_buckets = num_shards * cfg.avg_buckets_per_shard

    spans = shard_pipeline.batch_spans(lengths, batch_bases)
    nb = len(spans)
    if multiproc:
        from jax.experimental import multihost_utils

        nb = int(multihost_utils.process_allgather(np.asarray(nb)).max())
    offsets = np.concatenate([[0], np.cumsum(lengths)])

    def globalize(arr):
        if not multiproc:
            return jnp.asarray(arr.reshape(-1))
        sharding = NamedSharding(mesh, P(SHARD_AXIS))
        flat = np.ascontiguousarray(arr.reshape(-1))
        return jax.make_array_from_process_local_data(
            sharding, flat, (num_shards * flat.size // n_local,)
        )

    partials = []
    assign = None
    cfg2 = None
    tblock, tlmax = 0, 1
    for i in range(nb):
        if i < len(spans):
            s0, e0 = spans[i]
            b_codes = codes[offsets[s0]: offsets[e0]]
            b_lengths = lengths[s0:e0]
            rid0_batch = rid_offset + s0
        else:
            # Collective padding round: other hosts still have batches.
            b_codes = np.zeros(0, dtype=codes.dtype)
            b_lengths = np.zeros(0, dtype=np.int64)
            rid0_batch = 0
        flat_codes, flat_valid = fasta_io.flatten_for_device(
            b_codes, b_lengths, cfg.k, cfg.pad_multiple
        )
        dest = host_destinations(flat_codes, cfg.k, cfg.m, num_buckets)
        if assign is None:
            # Batch-0 bucket assignment fixes key ownership for the whole
            # stream (same rule as the non-EXT streaming loop above).
            sizes = np.bincount(
                dest[flat_valid.astype(bool)], minlength=num_buckets
            ).astype(np.int64)
            if multiproc:
                from jax.experimental import multihost_utils

                sizes = np.asarray(
                    multihost_utils.process_allgather(sizes).sum(axis=0),
                    dtype=np.int64,
                )
            if cfg.dispatcher == "balanced":
                assign = dispatch.balanced_assignment(sizes, num_shards)
            else:
                assign = dispatch.round_robin_assignment(
                    num_buckets, num_shards
                )
        shard_of = assign[dest]

        packed, lens, rid0, pos0, block_len, lmax = (
            _prepare_exchange_arrays(
                flat_codes, flat_valid, shard_of, b_lengths, rid0_batch,
                cfg, num_shards, n_local, multiproc, ext=True,
                min_block_len=tblock, min_lmax=tlmax,
            )
        )
        tblock, tlmax = max(tblock, block_len), max(tlmax, lmax)
        if cfg2 is None:
            cfg2 = dataclasses.replace(cfg, unfiltered=True)
        keys, cnt, keep, srid, spos = _exchange_count_supermer_ext_jit(
            globalize(packed), globalize(lens), globalize(rid0),
            globalize(pos0),
            cfg=cfg2, num_shards=num_shards, block_len=block_len,
            lmax=lmax, mesh=mesh,
        )
        partials.append(
            _assemble_ext_list(keys, cnt, keep, srid, spos, cfg, multiproc)
        )

    merged = merge_ext_partials(
        partials, cfg.lower, cfg.upper, cfg.k, cfg.words
    )
    if multiproc:
        hist = multihost._global_histogram(merged.counts, cfg.upper)
    else:
        from ..pipeline import host_histogram

        hist = host_histogram(merged.counts, cfg.upper)
    return merged, hist
