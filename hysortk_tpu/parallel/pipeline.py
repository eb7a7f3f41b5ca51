"""Sharded (multi-device / multi-host) k-mer counting pipeline.

SPMD redesign of the reference's rank pipeline (src/kmerops.cpp). The
default is the *range exchange*: one shard_map program per device batch does

  canonical keys -> invertible mix (ops/mixkey.py) -> ONE local sort
  -> contiguous per-destination segments -> all_to_all
  -> merge of the S received sorted runs (a lax.sort re-sort)
  -> run-length count -> [L,U] filter

Because the mixed sort key doubles as the routing key, the sharded step
costs one full local sort plus a receive-side merge — the
reference instead pays a full receive-side radix sort per task
(src/kmerops.cpp:535-541) because its MPI recv buffers arrive unsorted.

Ownership rule (range): dest = top bits of the mixed first word — uniform
even on skewed genomes since the mix has full avalanche. Equal keys mix
equally, so they land together: same correctness guarantee as the
reference's minimizer-hash ownership (src/kmerops.cpp:1044-1047).

The classifier (cfg.classifier == "heavy_hitter") runs a cheap measurement
pass first: exact per-(src,dst) slot maxima pre-size the exchange capacity
(no recompile-retry on skewed input), and destinations heavier than
heavy_ratio x mean — which under a keyed routing can only come from
heavy-hitter *duplicate* k-mers — switch the step to the combiner path,
where each shard pre-aggregates local duplicates and exchanges
(key, partial_count) pairs: the generalization of the reference's
ScatteredKmerList heavy-hitter path (src/kmerops.cpp:363-417, 1157-1199).

routing="minimizer" keeps the reference's virtual-task scheme (minimizer
buckets + balanced dispatcher) for parity; routing="kmer_hash" keeps the
legacy hash-mod scheme. Both use the bucketed (dest-sort) exchange.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..config import KmerConfig
from ..ops import count as count_ops
from ..ops import hashes
from ..ops import kmer as kmer_ops
from ..ops import mixkey
from ..ops import sort as sort_ops
from ..pipeline import KmerList
from . import exchange
from .mesh import SHARD_AXIS, make_mesh


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def run_with_capacity_retry(run, capacity: int, measured: bool):
    """Execute `run(capacity)` with the capacity-overflow protocol.

    `run` returns a tuple whose LAST element is the pmax'd overflow flag.
    Measured capacity is exact — one attempt; otherwise double up to 4x
    (pathological-skew fallback). Returns (outputs_without_flag, capacity).
    """
    attempts = 1 if measured else 4
    for _attempt in range(attempts):
        out = run(capacity)
        if int(jax.device_get(out[-1])) == 0:
            return out[:-1], capacity
        capacity *= 2
    raise RuntimeError(
        f"exchange capacity overflow after {attempts} attempts"
    )


def range_capacity(n_local: int, num_shards: int, cfg: KmerConfig) -> int:
    """Exchange slot capacity for range routing.

    Exact-capacity geometry (ops/spill.py): the merged plane is
    next_pow2(mean) — 1x n_local when the batch is pow2-flat, where the
    old next_pow2(capacity_factor * mean) rule always landed on 2x — plus
    a small pow2 spill lane for the hash-uniform overhang
    (sigma ~ sqrt(mean) << m/64). Mixed keys are hash-uniform per range,
    so only duplicate-key skew can overflow; that is the heavy-hitter
    classifier's job (combiner re-run), with the capacity-doubling retry
    as the last resort. EXT keeps the legacy single-plane pow2 capacity
    (occurrence payloads cannot ride the spill fold). Reference analogue:
    exact receive preallocation, src/kmerops.cpp:439-471.
    """
    if cfg.extension:
        return _next_pow2(
            max(int(n_local / num_shards * cfg.capacity_factor), 64)
        )
    mean = max(-(-n_local // num_shards), 128)
    # Capacity needs NO pow2 rounding of its own: each cell is a
    # contiguous slice of one sorted segment, so any slot count works on
    # the wire, and the receive side pads to 2 x (largest pow2 <= capacity)
    # for the merge geometry either way. Rounding the MEAN up to a pow2
    # first would, at a mean just above a pow2 boundary, ship 2.03x
    # n_local and merge 4x. mean + mean/64 keeps the hash-uniform overhang margin
    # (sigma ~ sqrt(mean) << mean/64) at every mean and degenerates to the
    # old geometry exactly when the mean is itself a power of two.
    return mean + max(mean >> 6, 64)


def _build_marked_mixed(codes, valid, cfg: KmerConfig):
    """codes/valid -> sentinel-marked, invertibly-mixed key words."""
    words = kmer_ops.canonical_words(codes.astype(jnp.int32), cfg.k)
    return mixkey.mix_keys(sort_ops.apply_sentinel(~valid, words))


def _bounds(cfg: KmerConfig) -> tuple[int, int]:
    return (1, 2**31 - 1) if cfg.unfiltered else (cfg.lower, cfg.upper)


def _empty_leftover_planes(n_words: int):
    """Uniform (1,)-dummy leftover planes. The spill lane now folds into
    the merged plane itself (_range_exchange_merge), so no path produces real leftovers; the slots
    stay in the 8-tuple shard-body contract so every routing returns the
    same pytree structure."""
    xw = tuple(
        jnp.full((1,), jnp.uint32(0xFFFFFFFF)) for _ in range(n_words)
    )
    return xw, jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.bool_)


def _count_merged(merged_words, cfg: KmerConfig):
    """Sorted sentinel-marked words -> (cnt, keep)."""
    lower, upper = _bounds(cfg)
    svalid = sort_ops.sentinel_valid(merged_words)
    head, cnt = count_ops.run_length_count(svalid, merged_words)
    keep = count_ops.frequency_filter(head, cnt, lower, upper)
    return cnt, keep


def _range_exchange_merge(
    mixed_s, payloads_s, cfg: KmerConfig, num_shards: int, capacity: int
):
    """Sorted mixed keys (+payloads) -> merged received runs (+payloads).

    The shared middle of the range pipelines: segment boundaries by
    searchsorted on static range boundaries, contiguous-range pack, padded
    all_to_all, sentinel-mask, merge. Returns
    (merged_words, merged_payloads, spill_words, spill_payloads,
    dest_totals, overflow_flag), where dest_totals are the global
    per-destination element counts — computed for FREE from the segment
    offsets the pack needs anyway, which is what lets the heavy-hitter
    classifier reuse them instead of paying a separate measurement sweep
    (the reference likewise classifies from counts it already has,
    src/kmerops.cpp:1157-1199).

    Exact-capacity geometry (ops/spill.py): capacity = m + sc with m the
    largest pow2. Each cell carries the segment's first `capacity`
    contiguous elements — the all_to_all ships ~2x fewer bytes than the
    old next_pow2(1.6 x mean) = 2m rule. The receive side sentinel-pads
    each run back to 2m before the merge (see ops/spill.py for the
    formulations this replaced). sc == 0 (pow2 capacity — EXT mode,
    legacy callers) keeps the 1x single-plane behavior. The padding and
    the pow2 run count below are a leftover of the bitonic merge network
    this build used to have; the lax.sort re-sort that replaced it does
    not need them (ROADMAP).
    """
    from ..ops import spill as spill_ops

    m, sc = spill_ops.split_capacity(capacity)
    n_valid = jnp.sum(sort_ops.sentinel_valid(mixed_s).astype(jnp.int32))
    bnd = mixkey.range_boundaries(num_shards)[1:-1].astype(np.uint32)
    inner = jnp.searchsorted(
        mixed_s[0], jnp.asarray(bnd), side="left"
    ).astype(jnp.int32)
    offsets = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), inner, n_valid[None]]
    )
    dest_totals = jax.lax.psum(jnp.diff(offsets), SHARD_AXIS)
    send_w, send_p, counts, overflow = exchange.pack_sorted_ranges(
        mixed_s, payloads_s, offsets, num_shards, capacity
    )
    recv_w, recv_p, _, recv_valid = exchange.all_to_all_exchange(
        send_w, send_p, counts, SHARD_AXIS
    )
    recv_w = exchange.mask_invalid_slots(recv_w, recv_valid)

    run = m
    if sc:
        # Exact capacity lives on the WIRE (m + sc slots per cell, the
        # ~2x all_to_all byte saving); the receive side pads each
        # received run to the next pow2 (2m) with sentinels.
        run = 2 * m
        pad = run - capacity
        full = jnp.full((num_shards, pad), jnp.uint32(0xFFFFFFFF))
        recv_w = [jnp.concatenate([w, full], axis=1) for w in recv_w]
        zeros = jnp.zeros((num_shards, pad), jnp.uint32)
        recv_p = [jnp.concatenate([p, zeros], axis=1) for p in recv_p]

    # Pad the run count to a power of two with all-sentinel runs (pow2 x
    # pow2 geometry; m is pow2 by construction).
    s2 = _next_pow2(num_shards)
    if s2 != num_shards:
        pad_rows = s2 - num_shards
        full = jnp.full((pad_rows, run), jnp.uint32(0xFFFFFFFF), jnp.uint32)
        recv_w = [jnp.concatenate([w, full]) for w in recv_w]
        zeros = jnp.zeros((pad_rows, run), jnp.uint32)
        recv_p = [jnp.concatenate([p, zeros]) for p in recv_p]

    _, merged_w, merged_p = sort_ops.sort_marked(
        [w.reshape(-1) for w in recv_w], [p.reshape(-1) for p in recv_p]
    )
    return merged_w, merged_p, dest_totals, overflow


def _shard_body_range(
    codes, valid, *, cfg: KmerConfig, num_shards: int, capacity: int
):
    """Default per-shard program: one sort, contiguous pack, merge."""
    mixed = _build_marked_mixed(codes.astype(jnp.int8), valid, cfg)
    _, mixed_s, _ = sort_ops.sort_marked(mixed)
    merged_w, _, totals, overflow = _range_exchange_merge(
        mixed_s, [], cfg, num_shards, capacity
    )
    cnt, keep = _count_merged(merged_w, cfg)
    xw, xcnt, xkeep = _empty_leftover_planes(len(merged_w))
    overflow = jax.lax.pmax(overflow.astype(jnp.int32), SHARD_AXIS)
    return (
        tuple(merged_w), cnt, keep, xw, xcnt, xkeep, totals,
        overflow,
    )


def _shard_body_range_combiner(
    codes, valid, *, cfg: KmerConfig, num_shards: int, capacity: int
):
    """Heavy-hitter per-shard program: pre-aggregate local duplicates, then
    exchange (mixed key, partial count) entries.

    Because destination order == mixed key order, the compaction of the
    per-distinct-key entries and their destination grouping are ONE sort:
    non-head slots are folded to the sentinel and sort away. Two sorts plus
    a receive-side merge total — the reference's heavy path instead re-sorts
    the gathered KmerList concatenation (src/kmerops.cpp:546-581).
    """
    mixed = _build_marked_mixed(codes.astype(jnp.int8), valid, cfg)
    _, mixed_s, _ = sort_ops.sort_marked(mixed)
    svalid = sort_ops.sentinel_valid(mixed_s)
    head, local_cnt = count_ops.run_length_count(svalid, mixed_s)
    full = jnp.uint32(0xFFFFFFFF)
    entry_words = [jnp.where(head, w, full) for w in mixed_s]
    _, entry_s, pay_s = sort_ops.sort_marked(
        entry_words, [local_cnt.astype(jnp.uint32)]
    )
    merged_w, merged_p, totals, overflow = (
        _range_exchange_merge(entry_s, pay_s, cfg, num_shards, capacity)
    )
    svalid2 = sort_ops.sentinel_valid(merged_w)
    head2, cnt = count_ops.run_length_sum(
        svalid2, merged_w, merged_p[0].astype(jnp.int32)
    )
    keep = count_ops.frequency_filter(head2, cnt, *_bounds(cfg))
    xw, xcnt, xkeep = _empty_leftover_planes(len(merged_w))
    overflow = jax.lax.pmax(overflow.astype(jnp.int32), SHARD_AXIS)
    return (
        tuple(merged_w), cnt, keep, xw, xcnt, xkeep, totals,
        overflow,
    )


def _shard_body_bucketed(
    codes, valid, assign, *, cfg: KmerConfig, num_shards: int, capacity: int
):
    """Bucketed exchange (minimizer / legacy hash routing, combiner path).

    assign: (num_buckets,) int32 bucket->shard table (minimizer routing), or
    a length-1 dummy for kmer_hash routing.
    """
    codes = codes.astype(jnp.int32)
    words = kmer_ops.canonical_words(codes, cfg.k)
    invalid = (~valid).astype(jnp.uint32)

    if cfg.routing == "minimizer":
        from ..ops import minimizer as minimizer_ops

        num_buckets = num_shards * cfg.avg_buckets_per_shard
        bucket = minimizer_ops.kmer_destinations(
            codes, cfg.k, cfg.m, num_buckets
        )
        dest = assign[bucket].astype(jnp.uint32)
    else:
        bucket = None
        dest = hashes.mix_words(words) % jnp.uint32(num_shards)

    if cfg.combiner:
        # Local pre-aggregation: one entry per distinct local key. With
        # minimizer routing the bucket id rides as the leading sort word
        # (equal keys share their minimizer, so (bucket, key) runs == key
        # runs) because the minimizer is positional and would be lost after
        # the sort.
        if cfg.routing == "minimizer":
            sort_words_in = [bucket.astype(jnp.uint32), *words]
        else:
            sort_words_in = list(words)
        inv_s, words_s_all, _ = sort_ops.sort_keys(invalid, sort_words_in)
        svalid = inv_s == 0
        head, local_cnt = count_ops.run_length_count(svalid, words_s_all)
        entry_invalid = (~head).astype(jnp.uint32)
        if cfg.routing == "minimizer":
            words_s = words_s_all[1:]
            entry_dest = assign[words_s_all[0].astype(jnp.int32)].astype(
                jnp.uint32
            )
        else:
            words_s = words_s_all
            entry_dest = hashes.mix_words(words_s) % jnp.uint32(num_shards)
        send_w, send_p, counts, overflow = exchange.pack_by_destination(
            entry_invalid, entry_dest, words_s, [local_cnt.astype(jnp.uint32)],
            num_shards, capacity,
        )
    else:
        send_w, send_p, counts, overflow = exchange.pack_by_destination(
            invalid, dest, words, [], num_shards, capacity
        )

    recv_w, recv_p, _, recv_valid = exchange.all_to_all_exchange(
        send_w, send_p, counts, SHARD_AXIS
    )

    flat_w = [w.reshape(-1) for w in recv_w]
    flat_valid = recv_valid.reshape(-1)
    flat_invalid = (~flat_valid).astype(jnp.uint32)

    if cfg.combiner:
        weights = recv_p[0].reshape(-1)
        inv_s, words_s, payloads_s = sort_ops.sort_keys(
            flat_invalid, flat_w, payloads=[weights]
        )
        weights_s = payloads_s[0].astype(jnp.int32)
        svalid = inv_s == 0
        head, cnt = count_ops.run_length_sum(svalid, words_s, weights_s)
    else:
        inv_s, words_s, _ = sort_ops.sort_keys(flat_invalid, flat_w)
        svalid = inv_s == 0
        head, cnt = count_ops.run_length_count(svalid, words_s)

    keep = count_ops.frequency_filter(head, cnt, *_bounds(cfg))
    overflow = jax.lax.pmax(overflow.astype(jnp.int32), SHARD_AXIS)
    totals = jax.lax.psum(counts.astype(jnp.int32), SHARD_AXIS)

    # Words returned separately (stacking on device wastes an HBM pass).
    # The histogram is computed host-side from the compacted counts (the
    # reference's count timer likewise excludes histogram work).
    xw, xcnt, xkeep = _empty_leftover_planes(len(words_s))
    return tuple(words_s), cnt, keep, xw, xcnt, xkeep, totals, overflow


@functools.partial(
    jax.jit, static_argnames=("cfg", "num_shards", "capacity", "mesh")
)
def _count_sharded_jit(codes, valid, assign, *, cfg, num_shards, capacity, mesh):
    word_specs = tuple(P(SHARD_AXIS) for _ in range(cfg.words))
    # (words, cnt, keep, spill_words, spill_cnt, spill_keep, totals, overflow)
    out_specs = (
        word_specs, P(SHARD_AXIS), P(SHARD_AXIS),
        word_specs, P(SHARD_AXIS), P(SHARD_AXIS), P(), P(),
    )
    if cfg.routing == "range":
        body = functools.partial(
            _shard_body_range_combiner if cfg.combiner else _shard_body_range,
            cfg=cfg, num_shards=num_shards, capacity=capacity,
        )
        return shard_map(
            body,
            mesh=mesh,
            in_specs=(P(SHARD_AXIS), P(SHARD_AXIS)),
            out_specs=out_specs,
            check_vma=False,
        )(codes, valid)
    body = functools.partial(
        _shard_body_bucketed, cfg=cfg, num_shards=num_shards, capacity=capacity
    )
    return shard_map(
        body,
        mesh=mesh,
        in_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P()),
        out_specs=out_specs,
        check_vma=False,
    )(codes, valid, assign)


# --- packed-wire variants (multihost feeding, ops/wire.py format) -----------


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "num_shards", "capacity", "block_len", "mesh"),
)
def _count_sharded_packed_jit(
    packed, lengths, *, cfg, num_shards, capacity, block_len, mesh
):
    """Range pipeline fed by the 2-bit packed wire (2 bits/base + 4 B/read
    host->device instead of 9 bits/base) — the device analogue of the
    reference's receive-side supermer parse (src/kmerops.cpp:484-521)."""
    from ..ops import wire

    assert cfg.routing == "range" and not cfg.combiner

    def body(pk, ln):
        codes, valid = wire.decode_block(pk, ln, cfg.k, block_len)
        return _shard_body_range(
            codes, valid, cfg=cfg, num_shards=num_shards, capacity=capacity
        )

    word_specs = tuple(P(SHARD_AXIS) for _ in range(cfg.words))
    return shard_map(
        body,
        mesh=mesh,
        in_specs=(P(SHARD_AXIS), P(SHARD_AXIS)),
        out_specs=(
            word_specs, P(SHARD_AXIS), P(SHARD_AXIS),
            word_specs, P(SHARD_AXIS), P(SHARD_AXIS), P(), P(),
        ),
        check_vma=False,
    )(packed, lengths)


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "num_shards", "capacity", "block_len", "mesh"),
)
def _count_sharded_ext_packed_jit(
    packed, lengths, rid_base, *, cfg, num_shards, capacity, block_len, mesh
):
    """EXT range pipeline on the wire format: (rid, pos) payloads are
    derived ON DEVICE from the read lengths (ops/wire.rid_pos_from_lengths)
    — they never travel host->device at all."""
    from ..ops import wire

    assert cfg.routing == "range"

    def body(pk, ln, rb):
        codes, valid = wire.decode_block(pk, ln, cfg.k, block_len)
        rid, pos = wire.rid_pos_from_lengths(ln, block_len, 0)
        rid = rid + rb[0]
        return _shard_body_ext_range(
            codes, valid, rid, pos,
            cfg=cfg, num_shards=num_shards, capacity=capacity,
        )

    word_specs = tuple(P(SHARD_AXIS) for _ in range(cfg.words))
    return shard_map(
        body,
        mesh=mesh,
        in_specs=(P(SHARD_AXIS),) * 3,
        out_specs=(word_specs,) + (P(SHARD_AXIS),) * 4 + (P(), P()),
        check_vma=False,
    )(packed, lengths, rid_base)


def distribute_reads_packed(
    codes: np.ndarray,
    lengths: np.ndarray,
    cfg: KmerConfig,
    num_shards: int,
    read_id_offset: int = 0,
    min_block_len: int = 0,
    min_lmax: int = 1,
) -> tuple[np.ndarray, np.ndarray, int, np.ndarray]:
    """Base-balanced per-shard blocks in wire format.

    Returns (packed (S * block_len/16,) uint32, lengths2d (S, lmax) int32,
    block_len, rid_base (S,) int32 — the global id of each shard's first
    read). block_len is a multiple of 16 and cfg.pad_multiple.

    min_block_len / min_lmax pin the output shapes from below so a batch
    stream compiles ONCE (streaming callers pass the first batch's dims).
    """
    from ..io import supermer as supermer_io

    per_shard = partition_read_indices(lengths, num_shards)
    offsets = np.concatenate([[0], np.cumsum(lengths)])

    shard_codes = []
    shard_lens = []
    rid_base = np.zeros(num_shards, dtype=np.int32)
    for s, part in enumerate(per_shard):
        if part:
            c = np.concatenate(
                [codes[offsets[i] : offsets[i + 1]] for i in part]
            )
            l = lengths[np.asarray(part, dtype=np.int64)].astype(np.int32)
            rid_base[s] = read_id_offset + part[0]
        else:
            c = np.zeros(0, dtype=codes.dtype)
            l = np.zeros(0, dtype=np.int32)
            rid_base[s] = read_id_offset
        shard_codes.append(c)
        shard_lens.append(l)

    gran = int(np.lcm(16, cfg.pad_multiple))
    raw = max(
        max(c.shape[0] for c in shard_codes) + 16, gran, min_block_len
    )
    block_len = -(-raw // gran) * gran
    lmax = max(max(l.shape[0] for l in shard_lens), 1, min_lmax)

    packed = np.zeros((num_shards, block_len // 16), dtype=np.uint32)
    lens2d = np.zeros((num_shards, lmax), dtype=np.int32)
    for s in range(num_shards):
        c = np.zeros(block_len, dtype=np.int8)
        c[: shard_codes[s].shape[0]] = shard_codes[s]
        packed[s] = supermer_io.pack_codes_2bit(c)
        lens2d[s, : shard_lens[s].shape[0]] = shard_lens[s]
    return packed.reshape(-1), lens2d, block_len, rid_base


@functools.partial(jax.jit, static_argnames=("cfg", "num_shards", "mesh"))
def _bucket_sizes_jit(codes, valid, *, cfg, num_shards, mesh):
    """Per-bucket k-mer counts: global totals (the classifier/dispatcher
    input — reference Reduce of task sizes, src/kmerops.cpp:1157-1199) AND
    the per-shard local sizes (S, B). The local matrix lets the planner
    derive EXACT per-(src,dst) exchange maxima from the assignment it is
    about to compute — no capacity_factor guess, no recompile-retry
    (reference analogue: exact prealloc from the count exchange,
    src/kmerops.cpp:751-812)."""
    from ..ops import minimizer as minimizer_ops
    from . import dispatch

    num_buckets = num_shards * cfg.avg_buckets_per_shard

    def body(codes, valid):
        bucket = minimizer_ops.kmer_destinations(
            codes.astype(jnp.int32), cfg.k, cfg.m, num_buckets
        )
        sizes = dispatch.bucket_sizes_device(bucket, valid, num_buckets)
        local = jax.lax.all_gather(sizes, SHARD_AXIS)
        return jax.lax.psum(sizes, SHARD_AXIS), local

    return shard_map(
        body,
        mesh=mesh,
        in_specs=(P(SHARD_AXIS), P(SHARD_AXIS)),
        out_specs=(P(), P()),
        check_vma=False,
    )(codes, valid)


def plan_sharded_step(
    codes_j, valid_j, cfg: KmerConfig, num_shards: int, mesh, n_local: int
) -> tuple[KmerConfig, jnp.ndarray, int, bool]:
    """Choose (cfg, bucket assignment, capacity, measured) for a step.

    Range routing needs NO measurement pass: the full-avalanche mix makes
    per-(src,dst) loads uniform, so a capacity_factor heuristic with the
    overflow-flag protocol suffices, and the heavy-hitter classifier reads
    the per-destination totals the main pass returns for free (see
    _range_exchange_merge) — skew costs one extra pass, balance costs zero.

    Minimizer routing with the balanced dispatcher measures global bucket
    sizes anyway (the dispatcher's input); the per-shard local sizes ride
    the same pass, so the per-(src,dst) maxima are EXACT and measured=True
    (overflow impossible, no retry path).
    """
    assign = jnp.zeros(1, dtype=jnp.int32)
    if cfg.routing == "minimizer":
        from . import dispatch

        num_buckets = num_shards * cfg.avg_buckets_per_shard
        need_sizes = cfg.dispatcher == "balanced"
        local_np = None
        if need_sizes:
            totals, local_sizes = _bucket_sizes_jit(
                codes_j, valid_j, cfg=cfg, num_shards=num_shards, mesh=mesh
            )
            local_np = np.asarray(local_sizes)
            assign_np = dispatch.balanced_assignment(
                np.asarray(totals), num_shards
            )
        else:
            assign_np = dispatch.round_robin_assignment(
                num_buckets, num_shards
            )
        if local_np is not None:
            # Exact per-(src,dst) slot maxima from the already-measured
            # local bucket sizes + the assignment (with the combiner on,
            # entries are distinct keys <= these raw counts: still an
            # upper bound, still overflow-free).
            onehot = np.zeros((num_buckets, num_shards), dtype=np.int64)
            onehot[np.arange(num_buckets), assign_np] = 1
            per_src_dst = local_np.astype(np.int64) @ onehot
            capacity = max(int(per_src_dst.max()), 64)
            return cfg, jnp.asarray(assign_np), capacity, True
        capacity = max(int(n_local / num_shards * cfg.capacity_factor), 64)
        return cfg, jnp.asarray(assign_np), capacity, False

    if cfg.routing == "range":
        return cfg, assign, range_capacity(n_local, num_shards, cfg), False

    capacity = max(int(n_local / num_shards * cfg.capacity_factor), 64)
    return cfg, assign, capacity, False


def count_flat_sharded(
    codes: np.ndarray,
    valid: np.ndarray,
    cfg: KmerConfig,
    mesh: Optional[Mesh] = None,
) -> tuple[KmerList, np.ndarray]:
    """Sharded pipeline entry: flat global (codes, valid) -> (KmerList, hist).

    `codes`/`valid` global length must be divisible by the shard count (the
    host loaders pad per shard).
    """
    mesh = mesh or make_mesh()
    num_shards = mesh.devices.size
    n = codes.shape[0]
    assert n % num_shards == 0, (n, num_shards)
    n_local = n // num_shards

    codes_j = jnp.asarray(codes, dtype=jnp.int8)
    valid_j = jnp.asarray(valid)

    cfg2, assign, capacity, measured = plan_sharded_step(
        codes_j, valid_j, cfg, num_shards, mesh, n_local
    )

    from . import dispatch

    # Heavy-hitter detection uses the per-destination totals the main pass
    # computes for free — no separate measurement sweep. A balanced input
    # pays zero extra passes; a skewed one pays one combiner re-run (the
    # reference's heavy path also re-processes those tasks,
    # src/kmerops.cpp:693-727).
    heavy_pending = (
        cfg2.routing == "range"
        and not cfg2.combiner
        and cfg2.classifier == "heavy_hitter"
        and not cfg2.extension
    )
    for _attempt in range(6):
        keys, cnt, keep, xw, xc, xk, totals, overflow = _count_sharded_jit(
            codes_j, valid_j, assign,
            cfg=cfg2, num_shards=num_shards, capacity=capacity, mesh=mesh,
        )
        if heavy_pending:
            heavy_pending = False
            types = dispatch.classify(np.asarray(totals), cfg2.heavy_ratio)
            if (types == dispatch.HEAVY).any():
                cfg2 = dataclasses.replace(cfg2, combiner=True)
                continue
        if int(jax.device_get(overflow)) == 0:
            break
        if measured:
            raise RuntimeError("overflow under exactly-measured capacity")
        capacity *= 2
    else:
        raise RuntimeError("exchange capacity overflow after retries")

    from ..pipeline import compact_keys, host_histogram

    keep_np = np.asarray(keep)
    compact = compact_keys(keys, keep_np)
    counts_np = np.asarray(cnt)[keep_np]
    if cfg2.routing == "range":
        compact = mixkey.unmix_keys_np(compact)
    kmerlist = KmerList(
        keys=compact,
        counts=counts_np,
        k=cfg.k,
    )
    return kmerlist, host_histogram(kmerlist.counts, cfg.upper)


def partition_read_indices(
    lengths: np.ndarray, num_shards: int
) -> list[list[int]]:
    """Greedy contiguous split of read indices balancing total bases —
    the in-memory analogue of the reference's getpartition
    (fastaindex.cpp:52-100)."""
    per_shard: list[list[int]] = [[] for _ in range(num_shards)]
    total = int(lengths.sum())
    target = total / num_shards if num_shards else 0
    shard, acc = 0, 0
    for i, ln in enumerate(lengths):
        if shard < num_shards - 1 and acc > 0 and acc + ln / 2 > target:
            shard += 1
            acc = 0
        per_shard[shard].append(i)
        acc += int(ln)
    return per_shard


def distribute_reads(
    codes: np.ndarray,
    lengths: np.ndarray,
    cfg: KmerConfig,
    num_shards: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side analogue of the reference's read partitioning: split reads
    into `num_shards` base-balanced groups (fastaindex.cpp:52-100) and build
    one equal-size flat (codes, valid) block per shard, concatenated."""
    from ..io import fasta as fasta_io

    offsets = np.concatenate([[0], np.cumsum(lengths)])
    per_shard = partition_read_indices(lengths, num_shards)

    blocks = []
    for part in per_shard:
        if part:
            c = np.concatenate(
                [codes[offsets[i] : offsets[i + 1]] for i in part]
            )
            l = lengths[np.asarray(part, dtype=np.int64)]
        else:
            c = np.zeros(0, dtype=codes.dtype)
            l = np.zeros(0, dtype=np.int64)
        blocks.append(
            fasta_io.flatten_for_device(c, l, cfg.k, cfg.pad_multiple)
        )
    block_len = max(b[0].shape[0] for b in blocks)
    out_codes = np.zeros((num_shards, block_len), dtype=np.int8)
    out_valid = np.zeros((num_shards, block_len), dtype=bool)
    for s, (c, v) in enumerate(blocks):
        out_codes[s, : c.shape[0]] = c
        out_valid[s, : v.shape[0]] = v
    return out_codes.reshape(-1), out_valid.reshape(-1)


def count_reads_sharded(
    codes: np.ndarray,
    lengths: np.ndarray,
    cfg: KmerConfig,
    mesh: Optional[Mesh] = None,
) -> tuple[KmerList, np.ndarray]:
    mesh = mesh or make_mesh()
    if cfg.routing == "supermer":
        from . import supermer_route

        return supermer_route.count_reads_supermer(codes, lengths, cfg, mesh)
    if cfg.routing == "range" and not cfg.combiner:
        # Feed devices over the 2-bit packed wire (~2 bits/base + 4 B/read
        # instead of 9 bits/base); falls through to the unpacked flow when
        # the classifier flags heavy-hitter destinations.
        from . import multihost

        result = multihost._count_multihost_packed(codes, lengths, cfg, mesh)
        if result is not None:
            return result
        cfg = dataclasses.replace(cfg, combiner=True)
    flat_codes, flat_valid = distribute_reads(
        codes, lengths, cfg, mesh.devices.size
    )
    return count_flat_sharded(flat_codes, flat_valid, cfg, mesh)


# ---------------------------------------------------------------------------
# Sharded streaming: bounded HBM at any input size on a mesh — the
# analogue of the reference's bounded-memory round loop
# (src/kmerops.cpp:906-1007). Device batches stream through the sharded
# exchange with an UNFILTERED count (every distinct key survives, the
# per-batch combiner idea of ScatteredKmerList, src/kmerops.cpp:363-417);
# compacted per-shard partial (key, count) lists accumulate in host RAM and
# a final no-exchange device pass merges them per shard (keys stay on their
# owner shard across batches because the routing rule is fixed).
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit, static_argnames=("cfg", "num_shards", "run_len", "mesh")
)
def _merge_partials_jit(words, cnts, *, cfg, num_shards, run_len, mesh):
    """Per-shard merge of accumulated partials: each per-batch partial is
    already an ascending sorted run (compacted from sorted device output);
    the merge is a lax.sort re-sort of the concatenation (see PERF.md for
    its cost against a bitonic merge network) — the analogue of the
    reference's count_sorted_kmerlist (src/kmerops.cpp:1447-1476).
    No exchange: keys are already owner-placed.

    words: tuple of W (S*R*run_len,) sentinel-marked key arrays laid out as
    R sentinel-padded pow2 runs per shard; cnts: same layout, u32 weights.
    """

    def body(*args):
        *ws, cn = args
        _, words_s, (pay,) = sort_ops.sort_marked(list(ws), [cn])
        svalid = sort_ops.sentinel_valid(words_s)
        head, total = count_ops.run_length_sum(
            svalid, words_s, pay.astype(jnp.int32)
        )
        keep = count_ops.frequency_filter(head, total, cfg.lower, cfg.upper)
        return tuple(words_s), total, keep

    w = len(words)
    word_specs = tuple(P(SHARD_AXIS) for _ in range(w))
    return shard_map(
        body,
        mesh=mesh,
        in_specs=(P(SHARD_AXIS),) * (w + 1),
        out_specs=(word_specs, P(SHARD_AXIS), P(SHARD_AXIS)),
        check_vma=False,
    )(*words, cnts)


def count_reads_sharded_streaming(
    codes: np.ndarray,
    lengths: np.ndarray,
    cfg: KmerConfig,
    batch_bases: int = 1 << 26,
    mesh: Optional[Mesh] = None,
    async_depth: Optional[int] = None,
) -> tuple[KmerList, np.ndarray]:
    """Bounded-memory multi-device counting: peak HBM is set by batch_bases
    (plus the compacted distinct-key partials of the final merge plus
    `async_depth` in-flight batches), not by the input size. Equivalent to
    count_reads_sharded (asserted in tests); results are independent of
    async_depth (FIFO settle). async_depth=None resolves from HBM headroom
    and key width (suggest_pipe_depth, capped at the measured-best 4) so
    wide-key configs never OOM by configuration.
    """
    from ..runtime.scheduler import iter_read_batches, suggest_pipe_depth

    if async_depth is None:
        async_depth = suggest_pipe_depth(
            batch_bases, cfg.words, max_depth=4
        )

    if cfg.extension:
        raise ValueError(
            "use count_reads_sharded_ext_streaming for extension mode"
        )
    if cfg.routing == "supermer":
        from . import supermer_route

        return supermer_route.count_reads_supermer_streaming(
            codes, lengths, cfg, batch_bases, mesh, async_depth
        )

    mesh = mesh or make_mesh()
    num_shards = mesh.devices.size
    cfg_pre_base = dataclasses.replace(cfg, unfiltered=True)

    partial_k: list[list[np.ndarray]] = [[] for _ in range(num_shards)]
    partial_c: list[list[np.ndarray]] = [[] for _ in range(num_shards)]

    plan = None
    target_block = None
    # Heavy-hitter routing is decided ONCE, from the totals of the first
    # batch's main pass (free — see _range_exchange_merge); the combiner
    # flag may not change mid-stream, but both paths share the mixed key
    # space so a batch-0 re-run is exact.
    heavy_pending = (
        cfg_pre_base.routing == "range"
        and not cfg_pre_base.combiner
        and cfg_pre_base.classifier == "heavy_hitter"
    )
    from . import dispatch

    # Comm/compute overlap: up to `async_depth` batches stay in flight —
    # jit dispatch is asynchronous, so the host packs batch t+1..t+d while
    # the devices run batch t, and the overflow flag is only read when a
    # batch leaves the window (the reference's double-buffered Ialltoall
    # rounds overlap exactly these, src/kmerops.cpp:906-1007). Settle
    # order is FIFO, so partials land in batch order and results are
    # depth-independent; an overflowed batch re-runs alone at the doubled
    # capacity when its flag is finally read.
    pending: list[tuple] = []

    def _settle(entry) -> None:
        nonlocal plan
        outs, b_codes_j, b_valid_j = entry
        for _attempt in range(6):
            if int(jax.device_get(outs[-1])) == 0:
                break
            cfg_pre, assign, capacity, measured = plan
            capacity *= 2
            plan = (cfg_pre, assign, capacity, measured)
            outs = _count_sharded_jit(
                b_codes_j, b_valid_j, assign,
                cfg=cfg_pre, num_shards=num_shards, capacity=capacity,
                mesh=mesh,
            )
        else:
            raise RuntimeError("exchange capacity overflow after 6 attempts")
        keys, cnt, keep, xw, xc, xk, _totals, _overflow = outs
        keep_np = np.asarray(keep)
        cnt_np = np.asarray(cnt)
        words_np = [np.asarray(w) for w in keys]
        out_len = keep_np.shape[0] // num_shards
        for s in range(num_shards):
            sl = slice(s * out_len, (s + 1) * out_len)
            km = keep_np[sl]
            partial_k[s].append(
                np.stack([w[sl][km] for w in words_np], axis=-1)
            )
            partial_c[s].append(cnt_np[sl][km].astype(np.uint32))

    for b_codes, b_lengths in iter_read_batches(codes, lengths, batch_bases):
        flat_c, flat_v = distribute_reads(b_codes, b_lengths, cfg, num_shards)
        block = flat_c.shape[0] // num_shards
        if target_block is None or block > target_block:
            # One compiled shape for the whole stream; grow only if a batch
            # genuinely exceeds it (oversized single read).
            target_block = -(-block // cfg.pad_multiple) * cfg.pad_multiple
        if block < target_block:
            c2 = np.zeros((num_shards, target_block), dtype=np.int8)
            v2 = np.zeros((num_shards, target_block), dtype=bool)
            c2[:, :block] = flat_c.reshape(num_shards, block)
            v2[:, :block] = flat_v.reshape(num_shards, block)
            flat_c, flat_v = c2.reshape(-1), v2.reshape(-1)
        codes_j = jnp.asarray(flat_c, jnp.int8)
        valid_j = jnp.asarray(flat_v)

        if plan is None:
            # Routing must stay fixed across batches (a key's owner shard
            # may not move); plan once on the first batch.
            plan = plan_sharded_step(
                codes_j, valid_j, cfg_pre_base, num_shards, mesh,
                target_block,
            )
        cfg_pre, assign, capacity, measured = plan

        outs = _count_sharded_jit(
            codes_j, valid_j, assign,
            cfg=cfg_pre, num_shards=num_shards, capacity=capacity,
            mesh=mesh,
        )
        if heavy_pending:
            # Batch 0 syncs once: the classify decision gates every later
            # batch's program, so it cannot ride the async window.
            heavy_pending = False
            types = dispatch.classify(
                np.asarray(outs[-2]), cfg_pre.heavy_ratio
            )
            if (types == dispatch.HEAVY).any():
                cfg_pre = dataclasses.replace(cfg_pre, combiner=True)
                plan = (cfg_pre, assign, capacity, measured)
                outs = _count_sharded_jit(
                    codes_j, valid_j, assign,
                    cfg=cfg_pre, num_shards=num_shards, capacity=capacity,
                    mesh=mesh,
                )
        pending.append((outs, codes_j, valid_j))
        if len(pending) >= async_depth:
            _settle(pending.pop(0))
    while pending:
        _settle(pending.pop(0))

    cfg_used = plan[0] if plan is not None else cfg_pre_base
    mixed_space = cfg_used.routing == "range"
    w = cfg.words

    if plan is None:
        return (
            KmerList(
                np.zeros((0, w), np.uint32), np.zeros(0, np.int32), cfg.k
            ),
            np.zeros(cfg.upper + 1, np.int32),
        )

    # Lay the per-(shard, batch) partials out as sentinel-padded pow2 runs
    # (each partial is already ascending).
    n_batches = max(len(pk) for pk in partial_k)
    run_len = _next_pow2(
        max(
            max((a.shape[0] for pk in partial_k for a in pk), default=1), 1
        )
    )
    n_runs = _next_pow2(n_batches)
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

    from ..pipeline import compact_keys, host_histogram

    keep_np = np.asarray(keep)
    compact = compact_keys(keys_s, keep_np)
    if mixed_space:
        compact = mixkey.unmix_keys_np(compact)
    kmerlist = KmerList(
        keys=compact, counts=np.asarray(total)[keep_np], k=cfg.k
    )
    return kmerlist, host_histogram(kmerlist.counts, cfg.upper)


# ---------------------------------------------------------------------------
# Extension (EXT=1) sharded pipeline: (ReadId, PosInRead) through the
# exchange — the reference's EXTENSION length_t wire format
# (include/kmer.hpp:346-360). The heavy-hitter/combiner path is unavailable
# in EXT mode, same restriction as the reference (src/kmerops.cpp:109-113).
# ---------------------------------------------------------------------------


def _shard_body_ext_range(
    codes, valid, rid, pos, *, cfg: KmerConfig, num_shards: int, capacity: int
):
    """EXT range pipeline: (rid, pos) payloads ride the sort and the merge.

    EXT keeps the legacy single-plane pow2 capacity (plan_sharded_step):
    occurrence payloads cannot be count-folded across a spill lane, so the
    spill planes _range_exchange_merge returns are always the empty
    dummies here.
    """
    assert capacity & (capacity - 1) == 0, (
        "EXT range exchange requires pow2 capacity (no spill lane)"
    )
    mixed = _build_marked_mixed(codes.astype(jnp.int8), valid, cfg)
    payloads = [rid.astype(jnp.uint32), pos.astype(jnp.uint32)]
    _, mixed_s, payl_s = sort_ops.sort_marked(mixed, payloads)
    merged_w, merged_p, totals, overflow = _range_exchange_merge(
        mixed_s, payl_s, cfg, num_shards, capacity
    )
    cnt, keep = _count_merged(merged_w, cfg)
    overflow = jax.lax.pmax(overflow.astype(jnp.int32), SHARD_AXIS)
    return (
        tuple(merged_w), cnt, keep, merged_p[0], merged_p[1], totals,
        overflow,
    )


def _shard_body_ext_bucketed(
    codes, valid, rid, pos, *, cfg: KmerConfig, num_shards: int, capacity: int
):
    codes = codes.astype(jnp.int32)
    words = kmer_ops.canonical_words(codes, cfg.k)
    invalid = (~valid).astype(jnp.uint32)
    dest = hashes.mix_words(words) % jnp.uint32(num_shards)

    send_w, send_p, counts, overflow = exchange.pack_by_destination(
        invalid, dest, words,
        [rid.astype(jnp.uint32), pos.astype(jnp.uint32)],
        num_shards, capacity,
    )
    recv_w, recv_p, _, recv_valid = exchange.all_to_all_exchange(
        send_w, send_p, counts, SHARD_AXIS
    )

    flat_w = [w.reshape(-1) for w in recv_w]
    flat_p = [p.reshape(-1) for p in recv_p]
    flat_invalid = (~recv_valid.reshape(-1)).astype(jnp.uint32)

    inv_s, words_s, payloads_s = sort_ops.sort_keys(
        flat_invalid, flat_w, payloads=flat_p
    )
    svalid = inv_s == 0
    head, cnt = count_ops.run_length_count(svalid, words_s)
    keep = count_ops.frequency_filter(head, cnt, *_bounds(cfg))
    overflow = jax.lax.pmax(overflow.astype(jnp.int32), SHARD_AXIS)
    totals = jax.lax.psum(counts.astype(jnp.int32), SHARD_AXIS)
    return (
        tuple(words_s), cnt, keep, payloads_s[0], payloads_s[1], totals,
        overflow,
    )


@functools.partial(
    jax.jit, static_argnames=("cfg", "num_shards", "capacity", "mesh")
)
def _count_sharded_ext_jit(
    codes, valid, rid, pos, *, cfg, num_shards, capacity, mesh
):
    if cfg.routing == "range":
        body = functools.partial(
            _shard_body_ext_range,
            cfg=cfg, num_shards=num_shards, capacity=capacity,
        )
    else:
        body = functools.partial(
            _shard_body_ext_bucketed,
            cfg=cfg, num_shards=num_shards, capacity=capacity,
        )
    word_specs = tuple(P(SHARD_AXIS) for _ in range(cfg.words))
    return shard_map(
        body,
        mesh=mesh,
        in_specs=(P(SHARD_AXIS),) * 4,
        out_specs=(word_specs,) + (P(SHARD_AXIS),) * 4 + (P(), P()),
        check_vma=False,
    )(codes, valid, rid, pos)


def build_ext_blocks(
    codes: np.ndarray,
    lengths: np.ndarray,
    cfg: KmerConfig,
    num_shards: int,
    read_id_offset: int = 0,
    min_block_len: int = 0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]:
    """Per-shard equal-size (codes, valid, rid, pos) blocks for EXT mode."""
    from ..io import fasta as fasta_io

    offsets = np.concatenate([[0], np.cumsum(lengths)])
    per_shard = partition_read_indices(lengths, num_shards)

    blocks = []
    for part in per_shard:
        if part:
            c = np.concatenate(
                [codes[offsets[i] : offsets[i + 1]] for i in part]
            )
            l = lengths[np.asarray(part, dtype=np.int64)]
            base = read_id_offset + part[0]
        else:
            c = np.zeros(0, dtype=codes.dtype)
            l = np.zeros(0, dtype=np.int64)
            base = read_id_offset
        blocks.append(
            fasta_io.flatten_for_device_ext(
                c, l, cfg.k, cfg.pad_multiple, base
            )
        )
    block_len = max(max(b[0].shape[0] for b in blocks), min_block_len)
    sc = np.zeros((num_shards, block_len), dtype=np.int8)
    sv = np.zeros((num_shards, block_len), dtype=bool)
    sr = np.zeros((num_shards, block_len), dtype=np.int32)
    sp = np.zeros((num_shards, block_len), dtype=np.uint32)
    for s, (c, v, r, p) in enumerate(blocks):
        sc[s, : c.shape[0]] = c
        sv[s, : v.shape[0]] = v
        sr[s, : r.shape[0]] = r
        sp[s, : p.shape[0]] = p
    return sc, sv, sr, sp, block_len


def batch_spans(lengths: np.ndarray, batch_bases: int) -> list[tuple[int, int]]:
    """Read-index spans of the streaming batches — THE batching rule
    (runtime/scheduler.read_batch_spans); shape pinning and the batch loop
    must agree exactly or a mid-stream batch recompiles."""
    from ..runtime.scheduler import read_batch_spans

    spans = read_batch_spans(lengths, batch_bases)
    return spans


def ext_stream_dims(
    lengths: np.ndarray, batch_bases: int, cfg: KmerConfig, num_shards: int
) -> tuple[int, int]:
    """Exact (block_len, lmax) upper bounds over every streaming batch.

    Simulated from lengths alone (cheap), so the whole stream compiles ONCE
    — shapes are pinned from below via the min_block_len/min_lmax params of
    the block builders.
    """
    gran = int(np.lcm(16, cfg.pad_multiple))
    max_raw, max_lmax = gran, 1
    for s, e in batch_spans(lengths, batch_bases):
        l = lengths[s:e]
        for part in partition_read_indices(l, num_shards):
            if part:
                bases = int(l[np.asarray(part, dtype=np.int64)].sum())
                max_raw = max(max_raw, bases + 16)
                max_lmax = max(max_lmax, len(part))
    return -(-max_raw // gran) * gran, max_lmax


def count_reads_sharded_ext_streaming(
    codes: np.ndarray,
    lengths: np.ndarray,
    cfg: KmerConfig,
    batch_bases: int = 1 << 26,
    mesh: Optional[Mesh] = None,
    read_id_offset: int = 0,
) -> tuple["KmerListExt", np.ndarray]:
    """Bounded-memory EXT counting on a mesh: peak HBM is set by
    batch_bases, not input size. Each batch runs the sharded EXT pass
    UNFILTERED; per-batch (key, count, occurrences) partials accumulate in
    host RAM and merge host-side ([L,U] applies to merged totals only) —
    the reference's EXT-indifferent bounded round loop
    (src/kmerops.cpp:906-1007: nothing in the exchange is EXT-conditional).
    """
    from ..pipeline import host_histogram, merge_ext_partials
    from ..runtime.scheduler import iter_read_batches

    mesh = mesh or make_mesh()
    cfg_pre = dataclasses.replace(cfg, unfiltered=True)
    min_dims = ext_stream_dims(
        lengths, batch_bases, cfg, mesh.devices.size
    )

    partials = []
    rid_off = read_id_offset
    for b_codes, b_lengths in iter_read_batches(codes, lengths, batch_bases):
        kl, _ = count_reads_sharded_ext(
            b_codes, b_lengths, cfg_pre, mesh,
            read_id_offset=rid_off, min_dims=min_dims,
        )
        partials.append(kl)
        rid_off += b_lengths.size
    merged = merge_ext_partials(
        partials, cfg.lower, cfg.upper, cfg.k, cfg.words
    )
    return merged, host_histogram(merged.counts, cfg.upper)


def count_reads_sharded_ext(
    codes: np.ndarray,
    lengths: np.ndarray,
    cfg: KmerConfig,
    mesh: Optional[Mesh] = None,
    read_id_offset: int = 0,
    min_dims: tuple[int, int] = (0, 1),
) -> tuple["KmerListExt", np.ndarray]:
    """Sharded EXT pipeline: per-kmer (rid, pos) occurrence lists.

    Under range routing the host->device feed is the 2-bit packed wire and
    the (rid, pos) payloads are derived on device from the read lengths —
    ~9x less wire than shipping (int8, bool, int32, uint32) per base.
    """
    from ..pipeline import KmerListExt, host_histogram

    mesh = mesh or make_mesh()
    if cfg.routing == "supermer":
        from . import supermer_route

        return supermer_route.count_reads_supermer_ext(
            codes, lengths, cfg, mesh, read_id_offset, min_dims
        )
    num_shards = mesh.devices.size

    if cfg.routing == "range":
        packed, lens2d, block_len, rid_base = distribute_reads_packed(
            codes, lengths, cfg, num_shards, read_id_offset,
            min_block_len=min_dims[0], min_lmax=min_dims[1],
        )
        packed_j = jnp.asarray(packed)
        lens_j = jnp.asarray(lens2d.reshape(-1))
        rid_j = jnp.asarray(rid_base)
        n_local = block_len

        # No measurement pass: range destinations are uniform (full-avalanche
        # mix), and EXT payload entries are raw occurrences either way, so
        # the heuristic + overflow-retry protocol is both exact and cheap.
        capacity = _next_pow2(
            max(int(n_local / num_shards * cfg.capacity_factor), 64)
        )
        (keys, cnt, keep, srid, spos, _totals), _ = run_with_capacity_retry(
            lambda cap: _count_sharded_ext_packed_jit(
                packed_j, lens_j, rid_j,
                cfg=cfg, num_shards=num_shards, capacity=cap,
                block_len=block_len, mesh=mesh,
            ),
            capacity, False,
        )
    else:
        sc, sv, sr, sp, block_len = build_ext_blocks(
            codes, lengths, cfg, num_shards, read_id_offset,
            min_block_len=min_dims[0],
        )
        n_local = block_len
        codes_j = jnp.asarray(sc.reshape(-1))
        valid_j = jnp.asarray(sv.reshape(-1))
        capacity = max(int(n_local / num_shards * cfg.capacity_factor), 64)
        (keys, cnt, keep, srid, spos, _totals), _ = run_with_capacity_retry(
            lambda cap: _count_sharded_ext_jit(
                codes_j,
                valid_j,
                jnp.asarray(sr.reshape(-1)),
                jnp.asarray(sp.reshape(-1)),
                cfg=cfg, num_shards=num_shards, capacity=cap, mesh=mesh,
            ),
            capacity, False,
        )

    keep_np = np.asarray(keep)
    cnt_np = np.asarray(cnt)
    srid_np = np.asarray(srid).astype(np.int32)
    spos_np = np.asarray(spos).astype(np.uint32)
    starts = np.flatnonzero(keep_np)
    counts = cnt_np[starts]
    from ..pipeline import compact_keys, split_occurrences

    compact = compact_keys(keys, keep_np)
    if cfg.routing == "range":
        compact = mixkey.unmix_keys_np(compact)
    pos_runs, rid_runs = split_occurrences(starts, counts, spos_np, srid_np)
    result = KmerListExt(
        keys=compact,
        counts=counts,
        k=cfg.k,
        pos=pos_runs,
        rid=rid_runs,
    )
    return result, host_histogram(result.counts, cfg.upper)
