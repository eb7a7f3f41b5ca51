"""Exact-capacity range exchange: the spill lane (ops/spill.py).

The spill lane only carries data when a per-(src,dst) segment exceeds the
pow2 main capacity m — at production scale that is fluctuation-level rare,
so these tests FORCE it by shrinking the planned capacity (monkeypatching
range_capacity) until segments routinely overhang into the spill slots,
then require exact oracle equality through the public entry points.
"""

import numpy as np
import pytest

import jax

from hysortk_tpu import KmerConfig
from hysortk_tpu.io import fasta as fasta_io
from hysortk_tpu.ops import spill
from hysortk_tpu import testing as oracle

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs multi-device (virtual CPU) mesh"
)

SENT = np.uint32(0xFFFFFFFF)


def test_split_capacity():
    assert spill.split_capacity(128) == (128, 0)
    assert spill.split_capacity(192) == (128, 64)
    assert spill.split_capacity((1 << 23) + (1 << 17)) == (1 << 23, 1 << 17)
    # Overflow-retry doubling preserves the (m, sc) split.
    m, sc = spill.split_capacity(2 * 192)
    assert (m, sc) == (256, 128)


def _force_capacity(monkeypatch, capacity):
    from hysortk_tpu.parallel import pipeline as sp

    monkeypatch.setattr(sp, "range_capacity", lambda *a, **k: capacity)


@pytest.mark.parametrize("combiner", [False, True])
@pytest.mark.parametrize("lower", [1, 2])
def test_sharded_spill_forced(monkeypatch, combiner, lower):
    """Public sharded path with segments overhanging the main lane: the
    planned capacity is shrunk so ~every (src,dst) segment spills, and the
    result must still match the oracle exactly (at lower=1 every
    singleton that crossed only in a spill lane must surface — spill keys
    fold into the plane via the extra merge level)."""
    from hysortk_tpu.parallel.mesh import make_mesh
    from hysortk_tpu.parallel.pipeline import count_flat_sharded, \
        distribute_reads

    rng = np.random.default_rng(41)
    reads = oracle.random_reads(rng, 60, 40, 80)
    reads = reads + reads[:30]
    cfg = KmerConfig(k=15, m=7, lower=lower, upper=100, combiner=combiner,
                     pad_multiple=128)
    mesh = make_mesh(jax.devices())
    codes, lengths = fasta_io.reads_to_codes(reads)
    flat_c, flat_v = distribute_reads(codes, lengths, cfg, 8)
    # ~4600 valid kmers over 64 segments => mean ~72; m=64 guarantees
    # routine spill, sc=32 absorbs it (overflow retry doubles and keeps
    # the split if a seed ever lands a >96 segment).
    _force_capacity(monkeypatch, 64 + 32)
    kmerlist, hist = count_flat_sharded(flat_c, flat_v, cfg, mesh)
    got = kmerlist.as_dict()
    want = {
        k.encode(): v
        for k, v in oracle.oracle_filtered(
            reads, cfg.k, cfg.lower, cfg.upper
        ).items()
    }
    assert got == want
    want_hist = oracle.oracle_histogram(
        oracle.oracle_filtered(reads, cfg.k, cfg.lower, cfg.upper)
    )
    got_hist = {c: int(n) for c, n in enumerate(hist) if n > 0}
    assert got_hist == want_hist


@pytest.mark.parametrize("lower", [1, 2])
def test_streaming_spill_forced(monkeypatch, lower):
    """Streaming sharded path under forced spill: per-batch spill keys
    must fold into each batch's merged plane and survive the final
    partial merge."""
    from hysortk_tpu.parallel.mesh import make_mesh
    from hysortk_tpu.parallel.pipeline import count_reads_sharded_streaming

    rng = np.random.default_rng(43)
    reads = oracle.random_reads(rng, 70, 40, 80)
    reads = reads + reads[:20]
    cfg = KmerConfig(k=15, m=7, lower=lower, upper=100, pad_multiple=128)
    mesh = make_mesh(jax.devices())
    codes, lengths = fasta_io.reads_to_codes(reads)
    _force_capacity(monkeypatch, 32 + 16)
    kmerlist, _ = count_reads_sharded_streaming(
        codes, lengths, cfg, batch_bases=1500, mesh=mesh
    )
    got = kmerlist.as_dict()
    want = {
        k.encode(): v
        for k, v in oracle.oracle_filtered(
            reads, cfg.k, cfg.lower, cfg.upper
        ).items()
    }
    assert got == want


def test_capacity_is_exact_at_pow2_batches():
    """The planned main plane must be 1x n_local/S (not 2x) for a pow2
    batch — the whole point of the spill design."""
    cfg = KmerConfig(k=31, m=17, lower=2, upper=50)
    from hysortk_tpu.parallel.pipeline import range_capacity

    cap = range_capacity(1 << 26, 8, cfg)
    m, sc = spill.split_capacity(cap)
    assert m == (1 << 23)  # exactly mean, not 2x
    assert sc == (1 << 17)
    # EXT keeps the legacy pow2 geometry.
    import dataclasses

    ext = dataclasses.replace(cfg, extension=True)
    cap_ext = range_capacity(1 << 26, 8, ext)
    assert spill.split_capacity(cap_ext)[1] == 0


def test_streaming_async_overflow_retry(monkeypatch):
    """A mid-stream overflow (capacity forced below a batch's segment max)
    must be caught at settle time and re-run at doubled capacity without
    corrupting FIFO partial order (async window exercised with depth 4)."""
    from hysortk_tpu.parallel.mesh import make_mesh
    from hysortk_tpu.parallel.pipeline import (
        count_reads_sharded, count_reads_sharded_streaming,
    )

    rng = np.random.default_rng(47)
    reads = oracle.random_reads(rng, 80, 40, 80)
    cfg = KmerConfig(k=15, m=7, lower=1, upper=1000, pad_multiple=128)
    mesh = make_mesh(jax.devices())
    codes, lengths = fasta_io.reads_to_codes(reads)
    # Absurdly small capacity: every batch overflows at least once and the
    # settle loop must double its way out (m=8, sc=4 -> 16+8 -> ...).
    _force_capacity(monkeypatch, 8 + 4)
    kl, _ = count_reads_sharded_streaming(
        codes, lengths, cfg, batch_bases=1400, mesh=mesh
    )
    want = {
        k.encode(): v
        for k, v in oracle.oracle_filtered(
            reads, cfg.k, cfg.lower, cfg.upper
        ).items()
    }
    assert kl.as_dict() == want
