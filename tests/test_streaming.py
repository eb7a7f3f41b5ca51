"""Streaming (bounded-memory) driver equals the one-shot pipeline."""

import numpy as np

from hysortk_tpu import KmerConfig, count_reads
from hysortk_tpu.io import fasta as fasta_io
from hysortk_tpu.runtime.scheduler import count_reads_streaming, iter_read_batches
from hysortk_tpu import testing as oracle


def test_batches_cover_reads_exactly():
    rng = np.random.default_rng(1)
    lengths = rng.integers(10, 50, size=30).astype(np.int64)
    codes = rng.integers(0, 4, size=int(lengths.sum())).astype(np.uint8)
    got_codes, got_lens = [], []
    for bc, bl in iter_read_batches(codes, lengths, batch_bases=100):
        assert bl.sum() <= 100 or bl.size == 1  # one oversized read allowed
        got_codes.append(bc)
        got_lens.append(bl)
    assert np.array_equal(np.concatenate(got_codes), codes)
    assert np.array_equal(np.concatenate(got_lens), lengths)


def test_streaming_equals_oneshot():
    rng = np.random.default_rng(77)
    reads = oracle.random_reads(rng, 60, 35, 90)
    reads = reads + reads[:25]
    cfg = KmerConfig(k=31, m=17, lower=2, upper=50, pad_multiple=256)
    codes, lengths = fasta_io.reads_to_codes(reads)

    one_list, one_hist = count_reads(codes, lengths, cfg)
    # Tiny batches force many partial lists + a real merge.
    st_list, st_hist = count_reads_streaming(
        codes, lengths, cfg, batch_bases=500
    )
    assert st_list.as_dict() == one_list.as_dict()
    assert np.array_equal(st_hist, one_hist)


def test_streaming_duplicates_across_batches():
    # The same kmer appearing in different batches must merge its counts.
    read = "ACGTTGCAACGGTACGTACCGGTTACGTACGCAGT"
    reads = [read] * 10
    cfg = KmerConfig(k=31, m=17, lower=10, upper=10, pad_multiple=128)
    codes, lengths = fasta_io.reads_to_codes(reads)
    st_list, _ = count_reads_streaming(codes, lengths, cfg, batch_bases=40)
    want = {
        k.encode(): v
        for k, v in oracle.oracle_filtered(reads, cfg.k, 10, 10).items()
    }
    assert st_list.as_dict() == want
    assert len(want) > 0


# --- sharded streaming (bounded HBM on a mesh) -------------------------------

import jax
import pytest

needs_mesh = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs multi-device (virtual CPU) mesh"
)


@needs_mesh
def test_sharded_streaming_equals_oneshot():
    from hysortk_tpu.parallel.pipeline import (
        count_reads_sharded,
        count_reads_sharded_streaming,
    )

    rng = np.random.default_rng(91)
    reads = oracle.random_reads(rng, 50, 35, 90)
    reads = reads + reads[:20]
    cfg = KmerConfig(k=31, m=17, lower=2, upper=50, pad_multiple=256)
    codes, lengths = fasta_io.reads_to_codes(reads)

    one_list, one_hist = count_reads_sharded(codes, lengths, cfg)
    st_list, st_hist = count_reads_sharded_streaming(
        codes, lengths, cfg, batch_bases=1200
    )
    assert st_list.as_dict() == one_list.as_dict()
    assert np.array_equal(st_hist, one_hist)


@needs_mesh
def test_sharded_streaming_duplicates_across_batches():
    read = "ACGTTGCAACGGTACGTACCGGTTACGTACGCAGTACGGTTAAC"
    reads = [read] * 12
    cfg = KmerConfig(k=31, m=17, lower=12, upper=12, pad_multiple=128)
    from hysortk_tpu.parallel.pipeline import count_reads_sharded_streaming

    codes, lengths = fasta_io.reads_to_codes(reads)
    st_list, _ = count_reads_sharded_streaming(
        codes, lengths, cfg, batch_bases=100
    )
    want = {
        k.encode(): v
        for k, v in oracle.oracle_filtered(reads, cfg.k, 12, 12).items()
    }
    assert st_list.as_dict() == want
    assert len(want) > 0


@needs_mesh
def test_sharded_streaming_heavy_single_batch_count():
    """A kmer whose per-batch count would exceed any uint16 cap must keep
    its exact total (a count above any per-batch cap must survive)."""
    from hysortk_tpu.parallel.pipeline import count_reads_sharded_streaming

    reads = ["A" * 2100]  # poly-A: one kmer, count 2070 in one batch
    cfg = KmerConfig(k=31, m=17, lower=2070, upper=2070, pad_multiple=128)
    codes, lengths = fasta_io.reads_to_codes(reads)
    st_list, _ = count_reads_sharded_streaming(
        codes, lengths, cfg, batch_bases=4096
    )
    assert len(st_list) == 1
    assert int(st_list.counts[0]) == 2070


# --- EXT streaming (bounded-memory extension mode) ---------------------------


def _ext_dict(kl):
    return kl.as_dict()


def test_streaming_ext_equals_oneshot_single_chip():
    """count_reads_streaming_ext == count_reads_ext: counts AND the full
    (rid, pos) occurrence sets, with tiny batches forcing real merges of
    keys that span batches."""
    from hysortk_tpu import count_reads_ext
    from hysortk_tpu.runtime.scheduler import count_reads_streaming_ext

    rng = np.random.default_rng(23)
    reads = oracle.random_reads(rng, 20, 35, 80)
    reads = reads + reads[:8]
    cfg = KmerConfig(k=31, m=17, lower=1, upper=50, extension=True,
                     pad_multiple=128)
    codes, lengths = fasta_io.reads_to_codes(reads)

    one, one_hist = count_reads_ext(codes, lengths, cfg)
    st, st_hist = count_reads_streaming_ext(
        codes, lengths, cfg, batch_bases=300
    )
    assert _ext_dict(st) == _ext_dict(one)
    assert np.array_equal(st_hist, one_hist)


@needs_mesh
def test_streaming_ext_equals_oneshot_sharded():
    from hysortk_tpu.parallel.pipeline import (
        count_reads_sharded_ext,
        count_reads_sharded_ext_streaming,
    )

    rng = np.random.default_rng(29)
    reads = oracle.random_reads(rng, 24, 35, 80)
    reads = reads + reads[:10]
    cfg = KmerConfig(k=31, m=17, lower=1, upper=50, extension=True,
                     pad_multiple=128)
    codes, lengths = fasta_io.reads_to_codes(reads)

    one, one_hist = count_reads_sharded_ext(codes, lengths, cfg)
    st, st_hist = count_reads_sharded_ext_streaming(
        codes, lengths, cfg, batch_bases=400
    )
    assert _ext_dict(st) == _ext_dict(one)
    assert np.array_equal(st_hist, one_hist)


@needs_mesh
def test_multihost_streaming_single_process(tmp_path):
    """count_fasta_multihost_streaming (the any-nprocs bounded-memory
    composition) equals the one-shot multihost path on the 1-process
    degenerate case; real 2-process coverage lives in
    tools/test_multiprocess.sh."""
    from hysortk_tpu.parallel.multihost import (
        count_fasta_multihost,
        count_fasta_multihost_streaming,
    )

    rng = np.random.default_rng(31)
    reads = oracle.random_reads(rng, 40, 35, 90) + ["ACGT" * 30] * 6
    fa = tmp_path / "mh.fa"
    with open(fa, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n{r}\n")
    cfg = KmerConfig(k=31, m=17, lower=1, upper=60, pad_multiple=128)
    one, one_hist = count_fasta_multihost(str(fa), cfg)
    st, st_hist = count_fasta_multihost_streaming(
        str(fa), cfg, batch_bases=600
    )
    assert st.as_dict() == one.as_dict()
    assert np.array_equal(st_hist, one_hist)


@needs_mesh
def test_multihost_ext_streaming_single_process(tmp_path):
    from hysortk_tpu.parallel.multihost import (
        count_fasta_multihost_ext,
        count_fasta_multihost_ext_streaming,
    )

    rng = np.random.default_rng(37)
    reads = oracle.random_reads(rng, 18, 35, 70)
    fa = tmp_path / "mhe.fa"
    with open(fa, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n{r}\n")
    cfg = KmerConfig(k=31, m=17, lower=1, upper=60, extension=True,
                     pad_multiple=128)
    one, one_hist = count_fasta_multihost_ext(str(fa), cfg)
    st, st_hist = count_fasta_multihost_ext_streaming(
        str(fa), cfg, batch_bases=400
    )
    assert _ext_dict(st) == _ext_dict(one)
    assert np.array_equal(st_hist, one_hist)


def test_chunked_partial_merge_equals_single_shot():
    """merge_partial_lists under a tiny element budget (forcing the
    key-range chunked device merges) must equal the unbounded merge."""
    from hysortk_tpu.runtime.scheduler import merge_partial_lists

    rng = np.random.default_rng(91)
    cfg = KmerConfig(k=31, m=17, lower=1, upper=65535, pad_multiple=128)
    parts_k, parts_c = [], []
    for _ in range(5):
        n = int(rng.integers(200, 600))
        keys = rng.integers(0, 1 << 32, size=(n, 2), dtype=np.uint32)
        # distinct within a partial (compacted device output invariant)
        keys = np.unique(keys, axis=0)  # also sorts lexicographically
        parts_k.append(keys)
        parts_c.append(
            rng.integers(1, 5, size=keys.shape[0]).astype(np.int32)
        )

    big_k, big_c = merge_partial_lists(parts_k, parts_c, cfg, 1 << 30)
    # budget below the padded single-shot size forces >= 2 chunks
    small_k, small_c = merge_partial_lists(parts_k, parts_c, cfg, 1024)
    assert np.array_equal(big_k, small_k)
    assert np.array_equal(big_c, small_c)

    # oracle: dict-summed totals
    acc = {}
    for pk, pc in zip(parts_k, parts_c):
        for row, c in zip(pk, pc):
            acc[tuple(row)] = acc.get(tuple(row), 0) + int(c)
    got = {tuple(r): int(c) for r, c in zip(big_k, big_c)}
    assert got == acc


def test_streaming_device_compact_equals_default():
    """device_compact pulls exact-size compacted slices (slow-link mode);
    results must be identical to the default masked pull."""
    import numpy as np

    from hysortk_tpu import KmerConfig
    from hysortk_tpu import testing as oracle
    from hysortk_tpu.io import fasta as fasta_io
    from hysortk_tpu.runtime.scheduler import count_reads_streaming

    rng = np.random.default_rng(77)
    reads = oracle.random_reads(rng, 40, 35, 120)
    reads = reads + reads[:20]
    codes, lengths = fasta_io.reads_to_codes(reads)
    cfg = KmerConfig(k=31, m=17, lower=2, upper=50, pad_multiple=256)
    cfg_dc = KmerConfig(k=31, m=17, lower=2, upper=50, pad_multiple=256,
                        device_compact=True)
    kl_a, hist_a = count_reads_streaming(codes, lengths, cfg, 700)
    kl_b, hist_b = count_reads_streaming(codes, lengths, cfg_dc, 700)
    assert kl_a.as_dict() == kl_b.as_dict()
    np.testing.assert_array_equal(hist_a, hist_b)


def test_count_reads_device_compact():
    import numpy as np

    from hysortk_tpu import KmerConfig, count_reads
    from hysortk_tpu import testing as oracle
    from hysortk_tpu.io import fasta as fasta_io

    rng = np.random.default_rng(78)
    reads = oracle.random_reads(rng, 30, 40, 90) * 2
    codes, lengths = fasta_io.reads_to_codes(reads)
    cfg = KmerConfig(k=31, m=17, lower=2, upper=50, pad_multiple=256,
                     device_compact=True)
    kl, hist = count_reads(codes, lengths, cfg)
    want = {k.encode(): v
            for k, v in oracle.oracle_filtered(reads, 31, 2, 50).items()}
    assert kl.as_dict() == want


def test_streaming_device_resident_merge(monkeypatch):
    """Device-resident accumulation (partials never cross to the host until
    the final result) must equal the host-accumulated path. CPU meshes
    report no HBM headroom, so force the budget decision."""
    import numpy as np

    from hysortk_tpu import KmerConfig
    from hysortk_tpu import testing as oracle
    from hysortk_tpu.io import fasta as fasta_io
    from hysortk_tpu.runtime import scheduler

    monkeypatch.setattr(
        scheduler, "_consolidation_group_size", lambda *a, **k: 8
    )
    rng = np.random.default_rng(81)
    reads = oracle.random_reads(rng, 36, 35, 120)
    reads = reads + reads[:18]
    codes, lengths = fasta_io.reads_to_codes(reads)
    cfg = KmerConfig(k=31, m=17, lower=2, upper=50, pad_multiple=256,
                     device_compact=True)
    kl, hist = scheduler.count_reads_streaming(codes, lengths, cfg, 700)
    want = {k.encode(): v
            for k, v in oracle.oracle_filtered(reads, 31, 2, 50).items()}
    assert kl.as_dict() == want
    counts = np.asarray(sorted(want.values()))
    np.testing.assert_array_equal(
        np.bincount(counts, minlength=51)[:51], hist
    )


def test_streaming_device_resident_consolidation(monkeypatch):
    """group=2 forces a consolidation cycle (merge + duplicate-sum +
    compact, all on device) after every second batch: many cycles, runs
    with partial validity, and a final merge over consolidated + fresh
    runs must still equal the oracle."""
    import numpy as np

    from hysortk_tpu import KmerConfig
    from hysortk_tpu import testing as oracle
    from hysortk_tpu.io import fasta as fasta_io
    from hysortk_tpu.runtime import scheduler

    monkeypatch.setattr(
        scheduler, "_consolidation_group_size", lambda *a, **k: 2
    )
    rng = np.random.default_rng(82)
    # Heavy duplication ACROSS batches: consolidation must sum partial
    # counts without filtering (a key seen once per batch but 5x overall
    # must survive lower=2).
    reads = oracle.random_reads(rng, 20, 35, 120) * 5
    rng.shuffle(reads)
    codes, lengths = fasta_io.reads_to_codes(reads)
    cfg = KmerConfig(k=31, m=17, lower=2, upper=50, pad_multiple=256,
                     device_compact=True)
    kl, hist = scheduler.count_reads_streaming(codes, lengths, cfg, 700)
    want = {k.encode(): v
            for k, v in oracle.oracle_filtered(reads, 31, 2, 50).items()}
    assert kl.as_dict() == want
    counts = np.asarray(sorted(want.values()))
    np.testing.assert_array_equal(
        np.bincount(counts, minlength=51)[:51], hist
    )


def test_streaming_consolidation_no_shrink_drains(monkeypatch):
    """All-distinct input: consolidation cannot shrink below `group`, so
    the scheduler must drain the summed runs to the host and still match
    the unstreamed result."""
    import numpy as np

    from hysortk_tpu import KmerConfig, count_reads
    from hysortk_tpu import testing as oracle
    from hysortk_tpu.io import fasta as fasta_io
    from hysortk_tpu.runtime import scheduler

    monkeypatch.setattr(
        scheduler, "_consolidation_group_size", lambda *a, **k: 2
    )
    rng = np.random.default_rng(83)
    reads = oracle.random_reads(rng, 30, 40, 90)  # k-mers ~all distinct
    codes, lengths = fasta_io.reads_to_codes(reads)
    cfg = KmerConfig(k=31, m=17, lower=1, upper=50, pad_multiple=256,
                     device_compact=True)
    kl, hist = scheduler.count_reads_streaming(codes, lengths, cfg, 600)
    want_kl, want_hist = count_reads(codes, lengths, cfg)
    assert kl.as_dict() == want_kl.as_dict()
    np.testing.assert_array_equal(hist, want_hist)
