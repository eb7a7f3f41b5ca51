"""Multi-host orchestration: distributed init, per-host reading, global mesh.

The reference scales across nodes with MPI ranks + Scatterv partitioning
(src/fastaindex.cpp:102-200). The JAX equivalents:

  * jax.distributed.initialize()   <-> MPI_Init across hosts
  * per-host .fai partition        <-> root getpartition + Scatterv (every
    host parses the small .fai itself and takes its slice; no root needed)
  * jax.make_array_from_process_local_data assembles the globally-sharded
    flat (codes, valid) arrays over one mesh of every host's devices
  * the shard_map pipeline (parallel/pipeline.py) then runs unchanged —
    XLA routes the all_to_all within a host and across hosts.

Single-process degenerates to the plain sharded pipeline, which is how CI
covers this module; real multi-host needs several machines.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import KmerConfig
from ..pipeline import KmerList
from .mesh import SHARD_AXIS
from . import pipeline as shard_pipeline


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Bring up the multi-host runtime (no-op if single-process or already up)."""
    if jax.process_count() > 1:
        return
    if coordinator_address is None:
        return  # single-host
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def read_my_shard(
    fasta_path: str, cfg: KmerConfig
) -> tuple[np.ndarray, np.ndarray]:
    """Each host reads its base-balanced slice of the FASTA.

    Unlike the reference (root parses + Scatterv, fastaindex.cpp:137-176),
    every host parses the small .fai independently and seeks its own byte
    range — no broadcast needed.
    """
    from ..io import fasta as fasta_io

    records = fasta_io.load_or_build_fai(fasta_path)
    parts = fasta_io.partition_records(records, jax.process_count())
    mine = [records[i] for i in parts[jax.process_index()]]
    return fasta_io.read_records(fasta_path, mine)


def _local_shards(arr) -> np.ndarray:
    """Concatenate this process's addressable shards of a global array."""
    return np.concatenate(
        [np.asarray(s.data) for s in arr.addressable_shards]
    )


def _global_histogram(counts: np.ndarray, upper: int) -> np.ndarray:
    """Per-host histogram summed across processes (the reference's
    MPI_Allreduce SUM, src/hysortk.cpp:115)."""
    from ..pipeline import host_histogram

    hist = host_histogram(counts, upper)
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        hist = np.asarray(
            multihost_utils.process_allgather(hist).sum(axis=0),
            dtype=np.int32,
        )
    return hist


def _gather_kmerlist(
    keys, cnt, keep, cfg: KmerConfig, unmix: bool
) -> KmerList:
    """Assemble this host's KmerList from sharded device outputs. The
    exact-capacity range exchange folds spill entries into the merged
    plane itself (parallel/pipeline._range_exchange_merge), so no leftover
    handling exists here."""
    keep_local = _local_shards(keep)
    keys_local = np.stack(
        [_local_shards(w)[keep_local] for w in keys], axis=-1
    )
    counts_local = _local_shards(cnt)[keep_local]
    if unmix:
        from ..ops import mixkey

        keys_local = mixkey.unmix_keys_np(keys_local)
    return KmerList(
        keys=keys_local,
        counts=counts_local,
        k=cfg.k,
    )


def count_fasta_multihost(
    fasta_path: str, cfg: KmerConfig
) -> tuple[KmerList, np.ndarray]:
    """Full multi-host pipeline: per-host read -> global mesh -> exchange count.

    Under the default range routing the host->device feed uses the 2-bit
    packed wire (ops/wire.py): ~2 bits/base + 4 B/read, the density of the
    reference's supermer wire (src/kmerops.cpp:1096-1148), instead of
    9 bits/base for (int8, bool). Falls back to the unpacked path for the
    bucketed routings and when the classifier engages the combiner.

    Returns this host's shard of the filtered list plus the global histogram.
    """
    codes, lengths = read_my_shard(fasta_path, cfg)
    if cfg.routing == "range" and not cfg.combiner:
        result = _count_multihost_packed(codes, lengths, cfg)
        if result is not None:
            return result
        # Heavy-hitter destinations: rerun through the combiner path.
        import dataclasses

        cfg = dataclasses.replace(cfg, combiner=True)
    return _count_multihost_unpacked(codes, lengths, cfg)


def _count_multihost_packed(
    codes: np.ndarray,
    lengths: np.ndarray,
    cfg: KmerConfig,
    mesh: Optional[Mesh] = None,
) -> Optional[tuple[KmerList, np.ndarray]]:
    """Packed-wire range pipeline; returns None if the classifier flags a
    heavy destination (caller switches to the combiner path).

    Works for any process count — with one process it is also the packed
    backend of count_reads_sharded (make_array_from_process_local_data
    degenerates to a sharded device_put).
    """
    from . import dispatch

    mesh = mesh if mesh is not None else Mesh(
        np.asarray(jax.devices()), (SHARD_AXIS,)
    )
    pidx = jax.process_index()
    n_local_dev = sum(
        1 for d in mesh.devices.flat if d.process_index == pidx
    )
    num_shards = mesh.devices.size

    packed2d, lens2d, block, _ = shard_pipeline.distribute_reads_packed(
        codes, lengths, cfg, n_local_dev
    )
    packed2d = packed2d.reshape(n_local_dev, -1)
    lmax = lens2d.shape[1]

    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        dims = multihost_utils.process_allgather(
            np.asarray([block, lmax])
        )
        block_max, lmax_max = int(dims[:, 0].max()), int(dims[:, 1].max())
    else:
        block_max, lmax_max = block, lmax
    if block_max != block:
        packed2d = np.pad(
            packed2d, ((0, 0), (0, (block_max - block) // 16))
        )
        block = block_max
    if lmax_max != lmax:
        lens2d = np.pad(lens2d, ((0, 0), (0, lmax_max - lmax)))
        lmax = lmax_max

    sharding = NamedSharding(mesh, P(SHARD_AXIS))
    packed_g = jax.make_array_from_process_local_data(
        sharding, np.ascontiguousarray(packed2d.reshape(-1)),
        (num_shards * block // 16,),
    )
    lens_g = jax.make_array_from_process_local_data(
        sharding, np.ascontiguousarray(lens2d.reshape(-1)),
        (num_shards * lmax,),
    )

    # Heavy-hitter detection reads the per-destination totals the main
    # pass returns for free (parallel/pipeline._range_exchange_merge) — no
    # measurement sweep; a skewed input costs one wasted pass (the caller
    # re-runs through the combiner), a balanced one costs zero.
    capacity = shard_pipeline.range_capacity(block, num_shards, cfg)
    for _attempt in range(6):
        keys, cnt, keep, xw, xc, xk, totals, overflow = (
            shard_pipeline._count_sharded_packed_jit(
                packed_g, lens_g,
                cfg=cfg, num_shards=num_shards, capacity=capacity,
                block_len=block, mesh=mesh,
            )
        )
        if cfg.classifier == "heavy_hitter":
            types = dispatch.classify(np.asarray(totals), cfg.heavy_ratio)
            if bool((types == dispatch.HEAVY).any()):
                return None
        if int(jax.device_get(overflow)) == 0:
            break
        capacity *= 2
    else:
        raise RuntimeError("exchange capacity overflow after retries")
    kmerlist = _gather_kmerlist(keys, cnt, keep, cfg, unmix=True)
    return kmerlist, _global_histogram(kmerlist.counts, cfg.upper)


def _count_multihost_unpacked(
    codes: np.ndarray, lengths: np.ndarray, cfg: KmerConfig
) -> tuple[KmerList, np.ndarray]:
    mesh = Mesh(np.asarray(jax.devices()), (SHARD_AXIS,))
    n_local_dev = jax.local_device_count()
    num_shards = mesh.devices.size
    # Distribute this host's reads over its local devices.
    local_codes, local_valid = shard_pipeline.distribute_reads(
        codes, lengths, cfg, n_local_dev
    )
    block = local_codes.shape[0] // n_local_dev

    # Equalize block sizes across hosts (the all-to-all needs a uniform
    # global shape): pad to the max block via a process allgather.
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        max_block = int(
            multihost_utils.process_allgather(np.asarray(block)).max()
        )
    else:
        max_block = block
    if max_block != block:
        lc = local_codes.reshape(n_local_dev, block)
        lv = local_valid.reshape(n_local_dev, block)
        pad = max_block - block
        lc = np.pad(lc, ((0, 0), (0, pad)))
        lv = np.pad(lv, ((0, 0), (0, pad)))
        local_codes, local_valid = lc.reshape(-1), lv.reshape(-1)
        block = max_block

    sharding = NamedSharding(mesh, P(SHARD_AXIS))
    global_shape = (num_shards * block,)
    codes_g = jax.make_array_from_process_local_data(
        sharding, local_codes.astype(np.int8), global_shape
    )
    valid_g = jax.make_array_from_process_local_data(
        sharding, local_valid, global_shape
    )

    cfg2, assign, capacity, measured = shard_pipeline.plan_sharded_step(
        codes_g, valid_g, cfg, num_shards, mesh, block
    )

    (keys, cnt, keep, xw, xc, xk, _totals), _ = (
        shard_pipeline.run_with_capacity_retry(
            lambda cap: shard_pipeline._count_sharded_jit(
                codes_g, valid_g, assign,
                cfg=cfg2, num_shards=num_shards, capacity=cap, mesh=mesh,
            ),
            capacity, measured,
        )
    )
    kmerlist = _gather_kmerlist(
        keys, cnt, keep, cfg, unmix=cfg2.routing == "range"
    )
    return kmerlist, _global_histogram(kmerlist.counts, cfg.upper)


def count_fasta_multihost_streaming(
    fasta_path: str, cfg: KmerConfig, batch_bases: int = 1 << 26
) -> tuple[KmerList, np.ndarray]:
    """Bounded-memory multi-host counting: every host streams its read
    shard through the global-mesh exchange in device batches of
    batch_bases; per-batch UNFILTERED partials accumulate per local device
    shard (keys never change owner — the routing rule is fixed) and one
    final collective merge pass sums them with the [L,U] filter. Peak HBM
    is set by batch_bases at ANY process count — the composition of the
    reference's bounded rounds with its rank sharding
    (src/kmerops.cpp:906-1007).
    """
    import dataclasses

    from . import dispatch

    if cfg.routing == "supermer":
        # This loop's exchange is the key-space one; silently running it
        # under a supermer request would swap the wire format the caller
        # asked for. Dispatch to the supermer rounds.
        from . import supermer_route

        return supermer_route.count_fasta_multihost_supermer_streaming(
            fasta_path, cfg, batch_bases
        )

    codes, lengths = read_my_shard(fasta_path, cfg)
    mesh = Mesh(np.asarray(jax.devices()), (SHARD_AXIS,))
    n_local_dev = jax.local_device_count()
    num_shards = mesh.devices.size
    cfg_pre = dataclasses.replace(cfg, unfiltered=True)

    # Agree on the batch count and one compiled block shape across hosts.
    spans = shard_pipeline.batch_spans(lengths, batch_bases)
    block = 0
    for s, e in spans:
        l = lengths[s:e]
        for part in shard_pipeline.partition_read_indices(l, n_local_dev):
            if part:
                block = max(
                    block, int(l[np.asarray(part, np.int64)].sum())
                )
    pad = cfg.pad_multiple
    block = max(-(-(block + 16) // pad) * pad, pad)
    nb = len(spans)
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        dims = multihost_utils.process_allgather(np.asarray([block, nb]))
        block, nb = int(dims[:, 0].max()), int(dims[:, 1].max())
    if nb == 0:
        from ..pipeline import host_histogram

        empty = KmerList(
            np.zeros((0, cfg.words), np.uint32), np.zeros(0, np.int32), cfg.k
        )
        return empty, host_histogram(empty.counts, cfg.upper)

    sharding = NamedSharding(mesh, P(SHARD_AXIS))
    gshape = (num_shards * block,)
    offsets = np.concatenate([[0], np.cumsum(lengths)])

    partial_k: list[list[np.ndarray]] = [[] for _ in range(n_local_dev)]
    partial_c: list[list[np.ndarray]] = [[] for _ in range(n_local_dev)]
    plan = None
    heavy_pending = (
        cfg_pre.routing == "range"
        and not cfg_pre.combiner
        and cfg_pre.classifier == "heavy_hitter"
    )
    # Comm/compute overlap (same protocol as the single-process streaming
    # loop): up to `async_depth` batches in flight, overflow flags read at
    # FIFO settle time. Every host reads the SAME replicated flag, so the
    # settle/retry control flow stays collective-deterministic. Depth
    # resolves from LOCAL headroom + key width; the allgathered min keeps
    # the window (and hence the collective schedule) identical everywhere.
    from ..runtime.scheduler import suggest_pipe_depth

    async_depth = suggest_pipe_depth(
        n_local_dev * block, cfg.words, max_depth=4
    )
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        async_depth = int(
            multihost_utils.process_allgather(
                np.asarray(async_depth)
            ).min()
        )
    pending: list[tuple] = []

    def _settle(entry) -> None:
        nonlocal plan
        outs, b_codes_g, b_valid_g = entry
        for _attempt in range(6):
            if int(jax.device_get(outs[-1])) == 0:
                break
            cfg_b, assign, capacity, measured = plan
            capacity *= 2
            plan = (cfg_b, assign, capacity, measured)
            outs = shard_pipeline._count_sharded_jit(
                b_codes_g, b_valid_g, assign,
                cfg=cfg_b, num_shards=num_shards, capacity=capacity,
                mesh=mesh,
            )
        else:
            raise RuntimeError("exchange capacity overflow after retries")
        keys, cnt, keep, xw, xc, xk, _totals, _overflow = outs
        keep_l = _local_shards(keep)
        cnt_l = _local_shards(cnt)
        words_l = [_local_shards(w) for w in keys]
        out_len = keep_l.shape[0] // n_local_dev
        for d in range(n_local_dev):
            sl = slice(d * out_len, (d + 1) * out_len)
            km = keep_l[sl]
            partial_k[d].append(
                np.stack([w[sl][km] for w in words_l], axis=-1)
            )
            partial_c[d].append(cnt_l[sl][km].astype(np.uint32))

    for i in range(nb):
        if i < len(spans):
            s, e = spans[i]
            b_codes = codes[offsets[s] : offsets[e]]
            b_lengths = lengths[s:e]
        else:
            b_codes = np.zeros(0, dtype=codes.dtype)
            b_lengths = np.zeros(0, dtype=np.int64)
        lc, lv = shard_pipeline.distribute_reads(
            b_codes, b_lengths, cfg, n_local_dev
        )
        lb = lc.shape[0] // n_local_dev
        assert lb <= block, (lb, block)
        if lb < block:
            c2 = np.zeros((n_local_dev, block), np.int8)
            v2 = np.zeros((n_local_dev, block), dtype=bool)
            c2[:, :lb] = lc.reshape(n_local_dev, lb)
            v2[:, :lb] = lv.reshape(n_local_dev, lb)
            lc, lv = c2.reshape(-1), v2.reshape(-1)
        codes_g = jax.make_array_from_process_local_data(
            sharding, lc.astype(np.int8), gshape
        )
        valid_g = jax.make_array_from_process_local_data(
            sharding, lv, gshape
        )
        if plan is None:
            # Collective planning on batch 0 (deterministic across hosts).
            plan = shard_pipeline.plan_sharded_step(
                codes_g, valid_g, cfg_pre, num_shards, mesh, block
            )
        cfg_b, assign, capacity, measured = plan
        outs = shard_pipeline._count_sharded_jit(
            codes_g, valid_g, assign,
            cfg=cfg_b, num_shards=num_shards, capacity=capacity,
            mesh=mesh,
        )
        if heavy_pending:
            # Batch 0 syncs once: classify gates later batches' programs.
            heavy_pending = False
            types = dispatch.classify(
                np.asarray(outs[-2]), cfg_b.heavy_ratio
            )
            if bool((types == dispatch.HEAVY).any()):
                cfg_b = dataclasses.replace(cfg_b, combiner=True)
                plan = (cfg_b, assign, capacity, measured)
                outs = shard_pipeline._count_sharded_jit(
                    codes_g, valid_g, assign,
                    cfg=cfg_b, num_shards=num_shards, capacity=capacity,
                    mesh=mesh,
                )
        pending.append((outs, codes_g, valid_g))
        if len(pending) >= async_depth:
            _settle(pending.pop(0))
    while pending:
        _settle(pending.pop(0))

    cfg_used = plan[0]
    w = cfg.words
    npart = max((len(pk) for pk in partial_k), default=1)
    run_len = max((a.shape[0] for pk in partial_k for a in pk), default=1)
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        dims = multihost_utils.process_allgather(
            np.asarray([run_len, npart])
        )
        run_len, npart = int(dims[:, 0].max()), int(dims[:, 1].max())
    run_len = shard_pipeline._next_pow2(max(run_len, 1))
    n_runs = shard_pipeline._next_pow2(max(nb, npart, 1))
    local_k = np.full(
        (n_local_dev, n_runs, run_len, w), 0xFFFFFFFF, dtype=np.uint32
    )
    local_c = np.zeros((n_local_dev, n_runs, run_len), dtype=np.uint32)
    for d in range(n_local_dev):
        for b, (ks, cs) in enumerate(zip(partial_k[d], partial_c[d])):
            local_k[d, b, : ks.shape[0]] = ks
            local_c[d, b, : cs.shape[0]] = cs
    flat_len = (num_shards * n_runs * run_len,)
    words_g = tuple(
        jax.make_array_from_process_local_data(
            sharding,
            np.ascontiguousarray(local_k[:, :, :, i].reshape(-1)),
            flat_len,
        )
        for i in range(w)
    )
    cnts_g = jax.make_array_from_process_local_data(
        sharding, np.ascontiguousarray(local_c.reshape(-1)), flat_len
    )
    keys_s, total, keep = shard_pipeline._merge_partials_jit(
        words_g, cnts_g,
        cfg=cfg, num_shards=num_shards, run_len=run_len, mesh=mesh,
    )
    kmerlist = _gather_kmerlist(
        keys_s, total, keep, cfg, unmix=cfg_used.routing == "range"
    )
    return kmerlist, _global_histogram(kmerlist.counts, cfg.upper)


def count_fasta_multihost_ext(
    fasta_path: str, cfg: KmerConfig
) -> tuple["KmerListExt", np.ndarray]:
    """Multi-host EXT pipeline: per-host read -> global mesh -> (rid, pos)
    payloads through the exchange (the reference's distributed EXTENSION
    mode, src/kmerops.cpp:1430-1438, include/kmer.hpp:346-430).

    Read ids are globally consistent: each host offsets its ids by the
    number of reads owned by lower-indexed hosts (the reference's MPI_Exscan
    of read counts, src/kmerops.cpp:66).
    """
    from ..io import fasta as fasta_io
    from ..pipeline import KmerListExt
    from jax.sharding import NamedSharding

    mesh = Mesh(np.asarray(jax.devices()), (SHARD_AXIS,))
    n_local_dev = jax.local_device_count()
    num_shards = mesh.devices.size

    records = fasta_io.load_or_build_fai(fasta_path)
    parts = fasta_io.partition_records(records, jax.process_count())
    my_part = parts[jax.process_index()]
    mine = [records[i] for i in my_part]
    # Global read-id offset: partitions are contiguous in record order.
    rid_offset = my_part[0] if my_part else 0
    codes, lengths = fasta_io.read_records(fasta_path, mine)

    kmerlist = _multihost_ext_pass(
        codes, lengths, cfg, mesh, n_local_dev, num_shards, rid_offset
    )
    return kmerlist, _global_histogram(kmerlist.counts, cfg.upper)


def _multihost_ext_pass(
    codes: np.ndarray,
    lengths: np.ndarray,
    cfg: KmerConfig,
    mesh: Mesh,
    n_local_dev: int,
    num_shards: int,
    rid_offset: int,
    min_block: int = 0,
) -> "KmerListExt":
    """One collective EXT exchange pass over the global mesh; returns this
    host's local-shard KmerListExt. min_block pins the compiled shape from
    below (streaming callers)."""
    from ..pipeline import KmerListExt, split_occurrences

    sc, sv, sr, sp, block = shard_pipeline.build_ext_blocks(
        codes, lengths, cfg, n_local_dev, rid_offset, min_block_len=min_block
    )

    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        max_block = int(
            multihost_utils.process_allgather(np.asarray(block)).max()
        )
    else:
        max_block = block
    if max_block != block:
        pad = ((0, 0), (0, max_block - block))
        sc, sv, sr, sp = (np.pad(a, pad) for a in (sc, sv, sr, sp))
        block = max_block

    sharding = NamedSharding(mesh, P(SHARD_AXIS))
    global_shape = (num_shards * block,)
    mk = lambda a: jax.make_array_from_process_local_data(
        sharding, np.ascontiguousarray(a.reshape(-1)), global_shape
    )
    codes_g, valid_g = mk(sc.astype(np.int8)), mk(sv)
    rid_g, pos_g = mk(sr), mk(sp)

    if cfg.routing == "range":
        capacity = shard_pipeline._next_pow2(
            max(int(block / num_shards * cfg.capacity_factor), 64)
        )
    else:
        capacity = max(int(block / num_shards * cfg.capacity_factor), 64)

    (keys, cnt, keep, srid, spos, _totals), _ = (
        shard_pipeline.run_with_capacity_retry(
            lambda cap: shard_pipeline._count_sharded_ext_jit(
                codes_g, valid_g, rid_g, pos_g,
                cfg=cfg, num_shards=num_shards, capacity=cap, mesh=mesh,
            ),
            capacity, False,
        )
    )

    keep_local = _local_shards(keep)
    cnt_local = _local_shards(cnt)
    srid_np = _local_shards(srid).astype(np.int32)
    spos_np = _local_shards(spos).astype(np.uint32)
    # Occurrence runs never span shard segments (keys are shard-owned), so
    # slicing the concatenated local arrays by [start, start+count) is safe.
    starts = np.flatnonzero(keep_local)
    counts = cnt_local[starts]
    keys_local = np.stack(
        [_local_shards(w)[keep_local] for w in keys], axis=-1
    )
    if cfg.routing == "range":
        from ..ops import mixkey

        keys_local = mixkey.unmix_keys_np(keys_local)
    pos_runs, rid_runs = split_occurrences(starts, counts, spos_np, srid_np)
    return KmerListExt(
        keys=keys_local,
        counts=counts,
        k=cfg.k,
        pos=pos_runs,
        rid=rid_runs,
    )


def count_fasta_multihost_ext_streaming(
    fasta_path: str, cfg: KmerConfig, batch_bases: int = 1 << 26
) -> tuple["KmerListExt", np.ndarray]:
    """Bounded-memory multi-host EXT counting: every host streams its read
    shard in device batches of batch_bases; per-batch UNFILTERED partials
    (keys stay on their owner shards — the routing rule is fixed) merge
    host-locally, with [L,U] applied to merged totals only. Peak HBM is set
    by batch_bases at any process count — the reference's bounded rounds at
    any nprocs (src/kmerops.cpp:906-1007)."""
    import dataclasses

    from ..io import fasta as fasta_io
    from ..pipeline import host_histogram, merge_ext_partials
    from ..runtime.scheduler import iter_read_batches

    mesh = Mesh(np.asarray(jax.devices()), (SHARD_AXIS,))
    n_local_dev = jax.local_device_count()
    num_shards = mesh.devices.size

    records = fasta_io.load_or_build_fai(fasta_path)
    parts = fasta_io.partition_records(records, jax.process_count())
    my_part = parts[jax.process_index()]
    mine = [records[i] for i in my_part]
    rid_offset = my_part[0] if my_part else 0
    codes, lengths = fasta_io.read_records(fasta_path, mine)

    cfg_pre = dataclasses.replace(cfg, unfiltered=True)

    # Agree on the batch count and the per-batch block shape across hosts
    # (stragglers feed empty batches; collectives need uniform shapes).
    spans = shard_pipeline.batch_spans(lengths, batch_bases)
    block, _ = shard_pipeline.ext_stream_dims(
        lengths, batch_bases, cfg, n_local_dev
    )
    nb = len(spans)
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        dims = multihost_utils.process_allgather(np.asarray([block, nb]))
        block, nb = int(dims[:, 0].max()), int(dims[:, 1].max())

    offsets = np.concatenate([[0], np.cumsum(lengths)])
    partials = []
    rid_off = rid_offset
    for i in range(nb):
        if i < len(spans):
            s, e = spans[i]
            b_codes = codes[offsets[s] : offsets[e]]
            b_lengths = lengths[s:e]
        else:
            b_codes = np.zeros(0, dtype=codes.dtype)
            b_lengths = np.zeros(0, dtype=np.int64)
        partials.append(
            _multihost_ext_pass(
                b_codes, b_lengths, cfg_pre, mesh, n_local_dev, num_shards,
                rid_off, min_block=block,
            )
        )
        rid_off += b_lengths.size

    merged = merge_ext_partials(
        partials, cfg.lower, cfg.upper, cfg.k, cfg.words
    )
    return merged, _global_histogram(merged.counts, cfg.upper)
