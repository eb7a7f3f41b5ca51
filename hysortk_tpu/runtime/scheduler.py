"""Streaming device-batch scheduler: bounded HBM regardless of input size.

The reference bounds memory by exchanging fixed-size rounds
(MAX_SEND_BATCH, src/kmerops.cpp:587-1007). The analogue here streams the
*input*: reads are processed in device batches of a fixed base budget; each
batch is counted unfiltered (a per-batch combiner pass producing compacted
{key, partial_count} lists, exactly the reference's ScatteredKmerList idea,
src/kmerops.cpp:363-417), and the partial lists are merged in a final device
pass (sort by key + weighted run-length sum, the analogue of
count_sorted_kmerlist, src/kmerops.cpp:1447-1476).

JAX's async dispatch gives double buffering for free: while batch i's device
work runs, the host packs batch i+1.
"""

from __future__ import annotations

import functools
import logging
import os
import time
from typing import Iterator

import jax
import jax.numpy as jnp
import numpy as np

from ..config import KmerConfig
from ..ops import count as count_ops
from ..ops import sort as sort_ops
from ..pipeline import KmerList

_LOG = logging.getLogger("hysortk_tpu.stream")


def read_batch_spans(
    lengths: np.ndarray, batch_bases: int
) -> list[tuple[int, int]]:
    """Read-index spans of ~batch_bases whole-read batches.

    Vectorized (one searchsorted per batch over the base prefix sums)
    instead of a per-read Python loop — the stream planner walks the spans
    three times (shape pinning, batch count, the batch loop itself), which
    at millions of reads would otherwise cost seconds per walk.
    """
    cum = np.cumsum(lengths.astype(np.int64))
    n = lengths.size
    spans = []
    start = 0
    base0 = 0
    while start < n:
        end = int(np.searchsorted(cum, base0 + batch_bases, side="right"))
        if end == start:  # single read larger than the budget
            end = start + 1
        spans.append((start, end))
        base0 = int(cum[end - 1])
        start = end
    return spans


def iter_read_batches(
    codes: np.ndarray,
    lengths: np.ndarray,
    batch_bases: int,
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Split (codes, lengths) into batches of whole reads, ~batch_bases each."""
    offsets = np.concatenate([[0], np.cumsum(lengths.astype(np.int64))])
    for start, end in read_batch_spans(lengths, batch_bases):
        yield (
            codes[offsets[start] : offsets[end]],
            lengths[start:end],
        )


def snap_batch_to_pow2_flat(batch_bases: int, pad_multiple: int) -> int:
    """Largest batch_bases <= the given one whose flattened device size
    (ceil((n+16)/pad)*pad) is EXACTLY a power of two.

    A sort that pads its input to the next power of two internally costs
    up to 2x for a batch one pad block above a boundary; whether the
    H100's lax.sort has such a cliff is not measured on the H100.
    Streaming batches are shape-free to choose, so always sit on the
    boundary.
    """
    # Pick the pow2 from batch_bases+16 itself, NOT from the padded size:
    # a pow2 inside (batch+16, padded] would yield flat-16 > batch_bases,
    # overshooting the (memory-derived) budget the caller handed in.
    flat = 1 << (max(int(batch_bases) + 16, 2).bit_length() - 1)
    if flat % pad_multiple or flat <= 16:
        return int(batch_bases)  # non-pow2 pad granularity: no snap
    return flat - 16


def suggest_batch_bases(cfg: KmerConfig, device=None) -> int:
    """Pick a streaming batch size from HBM headroom.

    The analogue of the reference's sort_decision (src/kmerops.cpp:1344-1379),
    which sizes its sorter from 90% of MemFree: here the device pipeline needs
    roughly codes(4) + 2 x W key words x 4 (pre/post sort) + counts/masks
    bytes per base; we leave 2x slack for XLA temporaries. The result is
    snapped so the flattened batch is exactly a power of two (see
    snap_batch_to_pow2_flat). The 2^28 cap bounds one batch's compiled
    shape; CPU devices report no memory stats and get 2^26.
    """
    from . import memcheck

    per_base = 4 + 2 * cfg.words * 4 + 8
    headroom = memcheck.hbm_headroom_bytes(device)
    if headroom is None:
        batch = 1 << 26
    else:
        batch = int(headroom / (2 * per_base))
        batch = max(min(batch, 1 << 28), 1 << 20)
    return snap_batch_to_pow2_flat(batch, cfg.pad_multiple)


def suggest_pipe_depth(
    batch_elems: int, words: int, device=None, max_depth: int = 8
) -> int:
    """How many batches may stay in flight (async dispatch) before a sync.

    Each in-flight batch holds its outputs alive — W key words + count +
    keep, ~(words + 2) x flat x 4 B — and the batch currently executing
    needs ~3x that as sort arena. Depth therefore scales DOWN with key
    width (the depth analogue of suggest_batch_bases, same lineage:
    reference sort_decision, src/kmerops.cpp:1344-1379). CPU devices
    report no memory stats and get depth 2.
    """
    from . import memcheck

    per_batch = (words + 2) * max(batch_elems, 1) * 4
    headroom = memcheck.hbm_headroom_bytes(device)
    if headroom is None:
        return min(2, max_depth)
    d = int((headroom - 4 * per_batch) // per_batch)
    return max(1, min(d, max_depth))


def count_reads_streaming_ext(
    codes: np.ndarray,
    lengths: np.ndarray,
    cfg: KmerConfig,
    batch_bases: int = 1 << 26,
    read_id_offset: int = 0,
):
    """Bounded-memory EXT counting on one device: each device batch runs the
    EXT pipeline UNFILTERED, per-batch (key, count, occurrences) partials
    merge host-side with the [L,U] filter applied to merged totals only —
    the reference's EXT-indifferent bounded round loop
    (src/kmerops.cpp:906-1007). Peak HBM is set by batch_bases."""
    from ..io import supermer as supermer_io
    from ..pipeline import (
        _count_device_ext_packed,
        assemble_ext_result,
        flat_size,
        host_histogram,
        merge_ext_partials,
    )

    snapped = snap_batch_to_pow2_flat(batch_bases, cfg.pad_multiple)
    if 0 < snapped <= batch_bases:
        batch_bases = snapped
    target = flat_size(batch_bases, cfg.pad_multiple)
    lmax = max(
        (
            ln.size
            for _, ln in iter_read_batches(codes, lengths, batch_bases)
        ),
        default=1,
    )

    partials = []
    rid_off = read_id_offset
    for b_codes, b_lengths in iter_read_batches(codes, lengths, batch_bases):
        # 2-bit wire feed; (rid, pos) derive on device from read lengths.
        n = max(target, flat_size(b_codes.size, cfg.pad_multiple))
        buf = np.zeros(n, dtype=np.int8)
        buf[: b_codes.size] = b_codes
        packed = supermer_io.pack_codes_2bit(buf)
        lens = np.zeros(max(lmax, 1), dtype=np.int32)
        lens[: b_lengths.size] = b_lengths
        # Unfiltered per-batch pass: the [L,U] filter only applies to
        # merged totals (see count_reads_streaming).
        keys, cnt, keep, srid, spos = _count_device_ext_packed(
            jnp.asarray(packed),
            jnp.asarray(lens),
            jnp.asarray([rid_off], dtype=jnp.int32),
            cfg.k,
            n,
            1,
            2**31 - 1,
        )
        partials.append(
            assemble_ext_result(keys, cnt, keep, srid, spos, cfg)
        )
        rid_off += b_lengths.size

    merged = merge_ext_partials(
        partials, cfg.lower, cfg.upper, cfg.k, cfg.words
    )
    return merged, host_histogram(merged.counts, cfg.upper)


def _consolidation_group_size(target: int, words: int, device=None) -> int:
    """How many run_len-slot runs the device-resident accumulator may hold.

    Per-batch compacted partials stay in HBM; whenever `group` runs have
    accumulated, a consolidation cycle (merge + duplicate-sum + compact,
    all on device) folds them into ceil(union/run_len) runs. Transient
    peak during the cycle ~= held runs (non-donated) + merge output +
    compaction arena + chunk sort scratch ~= 4.5x the held bytes, so
    group = headroom // (4.5 x run_len x (words+1) x 4 B), rounded down
    to a power of two (merge program shapes stay padded-stable) and capped
    at 8 (a cap on the merge program's size, not a measured optimum).
    Returns 0 to disable device-resident accumulation (host pulls), as on
    CPU devices, which report no memory stats.
    """
    forced = os.environ.get("HYSORTK_DEVICE_RESIDENT_GROUP")
    if forced is not None:
        return int(forced)
    from . import memcheck

    per_run = target * (words + 1) * 4
    headroom = memcheck.hbm_headroom_bytes(device)
    if headroom is None:
        return 0
    g = int(headroom // int(4.5 * per_run))
    if g < 2:
        return 0
    return 1 << min(g.bit_length() - 1, 3)


@functools.partial(
    jax.jit,
    static_argnames=("words", "run_len", "pad_runs"),
)
def _merge_runs_sum(parts_words, parts_cnts, lower, upper, *, words,
                    run_len, pad_runs):
    """Concat sorted runs + merge (a lax.sort re-sort; see PERF.md) +
    weighted run-length sum + [lower, upper] filter. The bounds are DYNAMIC operands, not static:
    consolidation passes (1, 2**31-1) — partial counts must survive
    unfiltered until the final merge — and the final merge passes the
    real bounds, and making that a static axis would compile two copies
    of this program for zero steady-state win. NOT donated: the caller's
    fallback drains the same partials to the host when this OOMs at
    runtime."""
    full = jnp.uint32(0xFFFFFFFF)
    wflat = []
    for w in range(words):
        cols = [p[w] for p in parts_words]
        cols += [jnp.full((run_len,), full, jnp.uint32)] * pad_runs
        wflat.append(jnp.concatenate(cols))
    ccols = [c.astype(jnp.uint32) for c in parts_cnts]
    ccols += [jnp.zeros((run_len,), jnp.uint32)] * pad_runs
    cflat = jnp.concatenate(ccols)
    _, words_s, (pay,) = sort_ops.sort_marked(wflat, [cflat])
    head, total = _run_length_sum(words_s, pay)
    keep = count_ops.frequency_filter(head, total, lower, upper)
    return tuple(words_s), total, keep


def _run_length_sum(words_s, pay):
    """Weighted run-length sum over sentinel-marked merged runs."""
    svalid = sort_ops.sentinel_valid(words_s)
    return count_ops.run_length_sum(svalid, words_s, pay.astype(jnp.int32))


@functools.partial(jax.jit, static_argnames=("chunk",))
def _compact_chunk(words_s, total, keep, off, *, chunk):
    """Fold + sort ONE static slice of a merged result. The merged array
    is globally sorted, so compacting run_len-sized chunks independently
    and concatenating preserves order — and every chunk reuses the
    per-batch compact sort's compiled shape instead of compiling a sort at
    runs x run_len."""
    full = jnp.uint32(0xFFFFFFFF)
    sl = lambda a: jax.lax.dynamic_slice_in_dim(a, off, chunk)
    keep_c = sl(keep)
    folded = [jnp.where(keep_c, sl(w), full) for w in words_s]
    _, cw, cp = sort_ops.sort_marked(folded, [sl(total).astype(jnp.uint32)])
    return tuple(cw), cp[0], jnp.sum(keep_c.astype(jnp.int32))


@functools.partial(jax.jit, donate_argnums=(0, 1))
def _arena_append(arena_ws, arena_c, chunk_ws, chunk_c, off):
    """Append a compacted chunk (kept prefix + sentinel tail) into the
    consolidation arena at a dynamic offset. The sentinel tail lands past
    the kept prefix and is overwritten by the next append (offsets advance
    by the kept count), so arena[0:union) ends up densely packed and
    sorted. Donated: the arena threads through appends in place."""
    new_ws = tuple(
        jax.lax.dynamic_update_slice(a, c, (off,))
        for a, c in zip(arena_ws, chunk_ws)
    )
    new_c = jax.lax.dynamic_update_slice(
        arena_c, chunk_c.astype(jnp.uint32), (off,)
    )
    return new_ws, new_c


@functools.partial(jax.jit, static_argnames=("run_len",))
def _extract_run(arena_ws, arena_c, idx, *, run_len):
    """Copy run idx out of the arena (a fresh buffer, so the big arena can
    free once every kept run is extracted)."""
    off = idx * run_len
    ws = tuple(
        jax.lax.dynamic_slice_in_dim(a, off, run_len) for a in arena_ws
    )
    return ws, jax.lax.dynamic_slice_in_dim(arena_c, off, run_len)


def _consolidate_device_runs(dev_words, dev_cnts, cfg, run_len):
    """Fold the held device-resident runs into ceil(union/run_len)
    compacted, sentinel-padded sorted runs — duplicate keys summed, NO
    [L,U] filter (partial counts must survive until the final merge).

    Device-only: nothing crosses the host link except one kept-count
    scalar per chunk. This is what lets arbitrarily long streams stay on
    device: run count shrinks back to the union size every `group`
    batches, the analogue of the reference's ScatteredKmerList pre-count
    (src/kmerops.cpp:363-417) applied transitively.
    """
    t0 = time.perf_counter()
    g = len(dev_words)
    next_pow2 = lambda x: 1 << max(int(x) - 1, 0).bit_length()
    runs = next_pow2(g)
    words_s, total, keep = _merge_runs_sum(
        tuple(tuple(p) for p in dev_words), tuple(dev_cnts),
        jnp.int32(1), jnp.int32(2**31 - 1),
        words=cfg.words, run_len=run_len, pad_runs=runs - g,
    )
    # Arena one run longer than the merged span: the last chunk's sentinel
    # tail must land inside the buffer without offset clamping.
    full = jnp.uint32(0xFFFFFFFF)
    arena_ws = tuple(
        jnp.full(((runs + 1) * run_len,), full, jnp.uint32)
        for _ in range(cfg.words)
    )
    arena_c = jnp.zeros(((runs + 1) * run_len,), jnp.uint32)
    off = 0
    for ci in range(runs):
        cw, cp, n_kept = _compact_chunk(
            list(words_s), total, keep, jnp.int32(ci * run_len),
            chunk=run_len,
        )
        nk = int(jax.device_get(n_kept))
        if nk == 0:
            continue
        arena_ws, arena_c = _arena_append(
            arena_ws, arena_c, tuple(cw), cp, jnp.int32(off)
        )
        off += nk
    del words_s, total, keep
    new_w, new_c, new_n = [], [], []
    n_runs = -(-off // run_len) if off else 0
    for i in range(n_runs):
        ws, c = _extract_run(arena_ws, arena_c, jnp.int32(i),
                             run_len=run_len)
        new_w.append(ws)
        new_c.append(c)
        new_n.append(min(run_len, off - i * run_len))
    jax.block_until_ready(new_c) if new_c else None
    _LOG.info(
        "consolidate: %d runs -> %d (union %d rows) in %.2fs",
        g, n_runs, off, time.perf_counter() - t0,
    )
    return new_w, new_c, new_n


def count_reads_streaming(
    codes: np.ndarray,
    lengths: np.ndarray,
    cfg: KmerConfig,
    batch_bases: int = 1 << 26,
) -> tuple[KmerList, np.ndarray]:
    """Count k-mers of an arbitrarily large read set in bounded device memory.

    Equivalent to count_reads() (asserted in tests); peak HBM is set by
    batch_bases, not by the input size.

    Under cfg.device_compact, when every per-batch compacted partial plus
    the final merge fits HBM, the partials STAY ON DEVICE and only the
    final filtered result crosses back to the host — zero intermediate
    device->host traffic (the whole point of the slow-link mode). Falls
    back to host-accumulated partials (chunked merge) otherwise.
    """
    from ..io import supermer as supermer_io
    from ..pipeline import (
        _count_device_packed,
        _count_device_packed_compact,
        flat_size,
        pull_prefix,
    )

    # Snap ANY requested budget onto a pow2 flat shape (<= the request, so
    # the memory bound holds; see snap_batch_to_pow2_flat).
    snapped = snap_batch_to_pow2_flat(batch_bases, cfg.pad_multiple)
    if 0 < snapped <= batch_bases:
        batch_bases = snapped
    partial_keys: list[np.ndarray] = []
    partial_cnts: list[np.ndarray] = []
    dev_words: list = []
    dev_cnts: list = []
    dev_nks: list = []

    # Uniform device shape across batches: one compile for the whole
    # stream. Oversized single reads still get their own (rare) shape.
    # The batch split is deterministic, so the max read count per batch is
    # known up front — lengths arrays pad to one static width too.
    target = flat_size(batch_bases, cfg.pad_multiple)
    lmax = max(
        (
            ln.size
            for _, ln in iter_read_batches(codes, lengths, batch_bases)
        ),
        default=1,
    )
    n_batches = sum(
        1 for _ in iter_read_batches(codes, lengths, batch_bases)
    )
    # Device-resident accumulation needs a pow2 run length (the run
    # merge's geometry) — guaranteed when batch_bases is pow2-snapped
    # (snap_batch_to_pow2_flat), the production configuration. `group`
    # runs are held at a time; consolidation folds them back down on
    # device, so stream length no longer forces host pulls.
    group = 0
    if cfg.device_compact and target & (target - 1) == 0:
        group = _consolidation_group_size(target, cfg.words)
    device_resident = group >= 2
    if cfg.device_compact:
        _LOG.info(
            "streaming: %d batches, target=%d, device_resident=%s group=%d",
            n_batches, target, device_resident, group,
        )

    def _drain_device_partials():
        """Pull retained device partials to host (fallback path)."""
        from ..pipeline import pull_prefix

        t0 = time.perf_counter()
        nbytes = 0
        for kw, kc, knk in zip(dev_words, dev_cnts, dev_nks):
            nk = int(jax.device_get(knk))
            pulled = pull_prefix(list(kw) + [kc], nk)
            partial_keys.append(np.stack(pulled[:-1], axis=-1))
            partial_cnts.append(pulled[-1].astype(np.uint32))
            nbytes += sum(p.nbytes for p in pulled)
        dev_words.clear()
        dev_cnts.clear()
        dev_nks.clear()
        dt = time.perf_counter() - t0
        _LOG.info(
            "drain: %.1f MB pulled in %.2fs (%.1f MB/s)",
            nbytes / 1e6, dt, nbytes / 1e6 / max(dt, 1e-9),
        )

    for b_codes, b_lengths in iter_read_batches(codes, lengths, batch_bases):
        # Feed over the 2-bit wire (~2 bits/base + 4 B/read H2D, the
        # sharded paths' format) instead of int8 codes + bool mask.
        # One read larger than the batch budget: rare one-off shape.
        n = max(target, flat_size(b_codes.size, cfg.pad_multiple))
        buf = np.zeros(n, dtype=np.int8)
        buf[: b_codes.size] = b_codes
        packed = supermer_io.pack_codes_2bit(buf)
        lens = np.zeros(max(lmax, 1), dtype=np.int32)
        lens[: b_lengths.size] = b_lengths
        # Unfiltered per-batch pre-count (filter only applies to final totals).
        # The upper bound here must be unbounded (NOT cfg.upper, and not
        # 65535): dropping a partial count whose single-batch frequency
        # exceeds any cap would silently corrupt the merged totals — the
        # final merge's [lower, upper] filter is the only real bound.
        args = (
            jnp.asarray(packed),
            jnp.asarray(lens),
            cfg.k,
            n,
            1,
            2**31 - 1,
        )
        if cfg.device_compact:
            # One extra device sort folds dropped slots away so the host
            # pull is ~distinct x 12 B instead of the full padded arrays
            # (see KmerConfig.device_compact).
            keys, cnt, n_kept = _count_device_packed_compact(*args)
            if device_resident:
                if n == target:
                    # Partials stay in HBM; nothing crosses to the host.
                    dev_words.append(keys)
                    dev_cnts.append(cnt)
                    dev_nks.append(n_kept)
                    if len(dev_words) >= group:
                        try:
                            dev_words, dev_cnts, dev_nks = (
                                _consolidate_device_runs(
                                    dev_words, dev_cnts, cfg, target
                                )
                            )
                        except jax.errors.JaxRuntimeError:
                            # _merge_runs_sum is NOT donated (its docstring
                            # exists for exactly this fallback), so the held
                            # runs survive a mid-cycle OOM: recover like the
                            # final-merge handler below instead of aborting
                            # the whole stream. The failed cycle's multi-GB
                            # transients free ASYNCHRONOUSLY — settle the
                            # allocator before the drain allocates its pull
                            # copies, or the drain OOMs on them.
                            _LOG.warning(
                                "device-resident consolidation ran out of "
                                "HBM; draining partials and continuing "
                                "host-side"
                            )
                            import gc

                            gc.collect()
                            jax.device_get(jnp.zeros(8))
                            device_resident = False
                            _drain_device_partials()
                            continue
                        if len(dev_words) >= max(group - 1, 2):
                            # Union occupies ~all held slots (distinct-heavy
                            # input): HBM is effectively full, and at
                            # group-1 every further batch would re-trigger a
                            # full union-sized consolidation (O(batches x
                            # union) device work) — drain the already-summed
                            # runs to the host and finish there. The
                            # max(.., 2) keeps group=2 (the test setting,
                            # where union <= 1 run is the steady state) on
                            # the device-resident path.
                            device_resident = False
                            _drain_device_partials()
                    continue
                # Oversized one-off batch breaks the uniform run length:
                # revert to host accumulation for the whole stream.
                device_resident = False
                _drain_device_partials()
            nk = int(jax.device_get(n_kept))
            pulled = pull_prefix(list(keys) + [cnt], nk)
            partial_keys.append(np.stack(pulled[:-1], axis=-1))
            partial_cnts.append(pulled[-1].astype(np.uint32))
        else:
            keys, cnt, keep = _count_device_packed(*args)
            keep_np = np.asarray(keep)
            from ..pipeline import compact_keys

            partial_keys.append(compact_keys(keys, keep_np))
            partial_cnts.append(np.asarray(cnt)[keep_np])

    if dev_words:
        from ..pipeline import host_histogram

        try:
            keys_np, cnts_np = _merge_device_resident(
                dev_words, dev_cnts, cfg, target
            )
            result = KmerList(keys_np, cnts_np, cfg.k)
            return result, host_histogram(result.counts, cfg.upper)
        except (RuntimeError, jax.errors.JaxRuntimeError) as e:
            # Merge didn't fit HBM after all (budget heuristic missed):
            # pull the compacted partials and finish host-side.
            import logging

            logging.getLogger("hysortk_tpu").warning(
                "device-resident merge failed (%s); draining to host",
                type(e).__name__,
            )
            # Settle the allocator first: the failed merge's transients
            # free asynchronously (same hazard as the consolidation
            # handler above).
            import gc

            gc.collect()
            jax.device_get(jnp.zeros(8))
            _drain_device_partials()

    if not partial_keys:
        return (
            KmerList(np.zeros((0, cfg.words), np.uint32), np.zeros(0, np.int32), cfg.k),
            np.zeros(cfg.upper + 1, np.int32),
        )

    keys_np, cnts_np = merge_partial_lists(
        partial_keys, partial_cnts, cfg,
        budget_elems=4 * snap_batch_to_pow2_flat(batch_bases, cfg.pad_multiple),
    )
    from ..pipeline import host_histogram

    result = KmerList(keys_np, cnts_np, cfg.k)
    return result, host_histogram(result.counts, cfg.upper)


def _merge_device_resident(dev_words, dev_cnts, cfg, run_len):
    """Merge device-retained per-batch (keys, counts) runs entirely on
    device; only the final filtered, compacted result crosses to the host.

    Shared jits with the consolidation cycle (_merge_runs_sum /
    _compact_chunk): (1) concat + run merge + weighted run-length
    sum + [L,U] filter; (2) per-chunk sentinel-fold + payload sort +
    n_kept. The reference's count_sorted_kmerlist plays role (1)
    (src/kmerops.cpp:1447-1476); role (2) has no reference analogue — its
    sorter output already lives in host memory.

    NOT donated: the caller's except handler drains these same partials
    to the host when the merge OOMs at RUNTIME (the exact miss the budget
    heuristic exists for) — donation would delete them and turn the
    graceful fallback into a hard crash.
    """
    from ..pipeline import narrow_counts, pull_prefix

    next_pow2 = lambda x: 1 << max(int(x) - 1, 0).bit_length()
    runs = next_pow2(len(dev_words))
    pad_runs = runs - len(dev_words)

    t0 = time.perf_counter()
    _LOG.info("device-resident merge: %d runs x %d", runs, run_len)
    lower, upper = (
        (1, 2**31 - 1) if cfg.unfiltered else (cfg.lower, cfg.upper)
    )
    words_s, total, keep = _merge_runs_sum(
        tuple(tuple(p) for p in dev_words),
        tuple(dev_cnts),
        jnp.int32(lower),
        jnp.int32(upper),
        words=cfg.words,
        run_len=run_len,
        pad_runs=pad_runs,
    )
    out_k, out_c = [], []
    nbytes = 0
    for off in range(0, runs * run_len, run_len):
        keys_s, cnt_s, n_kept = _compact_chunk(
            list(words_s), total, keep, jnp.int32(off), chunk=run_len,
        )
        nk = int(jax.device_get(n_kept))
        if nk == 0:
            continue
        # Counts are filtered to [lower, upper] here: pull them at the
        # narrowest width upper fits (10 B/row at u16 instead of 12).
        pulled = pull_prefix(
            list(keys_s) + [narrow_counts(cnt_s, upper)], nk
        )
        out_k.append(np.stack(pulled[:-1], axis=-1))
        out_c.append(pulled[-1].astype(np.int32))
        nbytes += sum(p.nbytes for p in pulled)
    _LOG.info(
        "device-resident merge + final pull: %.1f MB in %.2fs",
        nbytes / 1e6, time.perf_counter() - t0,
    )
    if not out_k:
        return (
            np.zeros((0, cfg.words), np.uint32), np.zeros(0, np.int32)
        )
    return np.concatenate(out_k), np.concatenate(out_c)


def _merge_chunk_jit():
    """The shared device merge of padded sorted runs (one compile per
    (words, run_len, n_runs, L, U) shape class)."""
    import functools

    from ..ops import count as count_ops
    from ..ops import sort as sort_ops

    @functools.partial(
        jax.jit,
        static_argnames=("words", "lower", "upper", "run_len", "compact"),
    )
    def merge(keys, cnts, *, words, lower, upper, run_len, compact=False):
        wlist = [keys[:, :, w].reshape(-1) for w in range(words)]
        _, words_s, (pay,) = sort_ops.sort_marked(wlist, [cnts.reshape(-1)])
        head, total = _run_length_sum(words_s, pay)
        keep = count_ops.frequency_filter(head, total, lower, upper)
        if compact:
            # One payload sort folds dropped slots away so the host pulls
            # ~result x 12 B, not the full padded merge.
            full = jnp.uint32(0xFFFFFFFF)
            folded = [jnp.where(keep, w, full) for w in words_s]
            _, cw, cp = sort_ops.sort_marked(
                folded, [total.astype(jnp.uint32)]
            )
            return tuple(cw), cp[0], jnp.sum(keep.astype(jnp.int32))
        return tuple(words_s), total, keep

    return merge


def merge_partial_lists(
    partial_keys: list[np.ndarray],
    partial_cnts: list[np.ndarray],
    cfg: KmerConfig,
    budget_elems: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Merge ascending (keys, partial_count) lists with bounded HBM.

    Each partial is already sorted (compacted device output) and the
    device pass merges the runs (a lax.sort re-sort). When the padded
    composition exceeds `budget_elems` total elements — a distinct-heavy stream can make the union as large as the
    input, far over HBM — the merge runs in KEY-RANGE CHUNKS: boundaries on
    the leading key word are chosen so every chunk fits the budget, each
    partial contributes a contiguous slice per chunk (host searchsorted),
    chunks share ONE jit shape, and the filtered outputs concatenate in
    range order. The reference's memory bound comes from its fixed-size
    exchange rounds (src/kmerops.cpp:587-1007); chunked merging is the
    analogue on the result side (count_sorted_kmerlist, :1447-1476).
    """
    next_pow2 = lambda x: 1 << max(int(x) - 1, 0).bit_length()
    n_runs = next_pow2(len(partial_keys))
    run_len_1 = next_pow2(max(max(p.shape[0] for p in partial_keys), 1))
    merge = _merge_chunk_jit()

    def run_merge(chunk_keys, chunk_cnts, run_len):
        all_keys = np.full(
            (n_runs, run_len, cfg.words), 0xFFFFFFFF, dtype=np.uint32
        )
        all_cnts = np.zeros((n_runs, run_len), dtype=np.uint32)
        for i, (pk, pc) in enumerate(zip(chunk_keys, chunk_cnts)):
            all_keys[i, : pk.shape[0]] = pk
            all_cnts[i, : pc.shape[0]] = pc
        out = merge(
            jnp.asarray(all_keys),
            jnp.asarray(all_cnts),
            words=cfg.words,
            lower=cfg.lower,
            upper=cfg.upper,
            run_len=run_len,
            compact=cfg.device_compact,
        )
        if cfg.device_compact:
            from ..pipeline import narrow_counts, pull_prefix

            keys_s, total, n_kept = out
            nk = int(jax.device_get(n_kept))
            pulled = pull_prefix(
                list(keys_s) + [narrow_counts(total, cfg.upper)], nk
            )
            return (
                np.stack(pulled[:-1], axis=-1),
                pulled[-1].astype(np.int32),
            )
        keys_s, total, keep = out
        from ..pipeline import compact_keys

        keep_np = np.asarray(keep)
        return (
            compact_keys(keys_s, keep_np),
            np.asarray(total)[keep_np].astype(np.int32),
        )

    if n_runs * run_len_1 <= max(budget_elems, 1 << 20):
        return run_merge(partial_keys, partial_cnts, run_len_1)

    # Chunked path: oversampled uniform edges on the leading word, grouped
    # greedily so each chunk's padded size fits the budget.
    total = sum(p.shape[0] for p in partial_keys)
    n_chunks_min = -(-total // max(budget_elems // 2, 1))
    s = 8 * next_pow2(n_chunks_min)
    edges = (np.arange(1, s, dtype=np.uint64) * (1 << 32) // s).astype(
        np.uint32
    )
    offs = [
        np.concatenate(
            [
                [0],
                np.searchsorted(pk[:, 0], edges, side="left"),
                [pk.shape[0]],
            ]
        ).astype(np.int64)
        for pk in partial_keys
    ]
    interval_sizes = np.sum(
        [o[1:] - o[:-1] for o in offs], axis=0
    )  # (s,) totals
    # Greedy grouping of consecutive intervals under the element budget.
    groups: list[tuple[int, int]] = []
    lo = 0
    acc = 0
    for idx in range(s):
        if acc and acc + interval_sizes[idx] > budget_elems // 2:
            groups.append((lo, idx))
            lo, acc = idx, 0
        acc += int(interval_sizes[idx])
    groups.append((lo, s))
    # One jit shape for every chunk: pad to the global max slice length.
    run_len = next_pow2(
        max(
            int(np.max([o[b] - o[a] for o in offs]))
            for a, b in groups
        )
        or 1
    )
    out_keys, out_cnts = [], []
    for a, b in groups:
        ck = [pk[o[a] : o[b]] for pk, o in zip(partial_keys, offs)]
        cc = [pc[o[a] : o[b]] for pc, o in zip(partial_cnts, offs)]
        if not any(x.shape[0] for x in ck):
            continue
        k_np, c_np = run_merge(ck, cc, run_len)
        out_keys.append(k_np)
        out_cnts.append(c_np)
    if not out_keys:
        return (
            np.zeros((0, cfg.words), np.uint32),
            np.zeros(0, np.int32),
        )
    return np.concatenate(out_keys), np.concatenate(out_cnts)
