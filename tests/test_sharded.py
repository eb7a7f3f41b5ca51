"""Multi-device pipeline on an 8-virtual-device CPU mesh vs the oracle."""

import numpy as np
import pytest

import jax

from hysortk_tpu import KmerConfig
from hysortk_tpu.io import fasta as fasta_io
from hysortk_tpu.parallel.pipeline import count_reads_sharded
from hysortk_tpu.parallel.mesh import make_mesh
from hysortk_tpu import testing as oracle

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs multi-device (virtual CPU) mesh"
)


def _run(reads, cfg, n_dev=None):
    devs = jax.devices()[: n_dev or len(jax.devices())]
    mesh = make_mesh(devs)
    codes, lengths = fasta_io.reads_to_codes(reads)
    kmerlist, hist = count_reads_sharded(codes, lengths, cfg, mesh)
    return kmerlist.as_dict(), hist


def _expect(reads, cfg):
    filt = oracle.oracle_filtered(reads, cfg.k, cfg.lower, cfg.upper)
    return {k.encode(): v for k, v in filt.items()}


@pytest.mark.parametrize("combiner", [False, True])
def test_sharded_matches_oracle(combiner):
    rng = np.random.default_rng(17)
    reads = oracle.random_reads(rng, 48, 35, 90)
    reads = reads + reads[:24] + reads[:8]
    cfg = KmerConfig(k=31, m=17, lower=2, upper=50, combiner=combiner,
                     pad_multiple=256)
    got, hist = _run(reads, cfg)
    want = _expect(reads, cfg)
    assert got == want
    want_hist = oracle.oracle_histogram(
        oracle.oracle_filtered(reads, cfg.k, cfg.lower, cfg.upper)
    )
    got_hist = {c: int(n) for c, n in enumerate(hist) if n > 0}
    assert got_hist == want_hist


def test_sharded_two_devices_k15():
    rng = np.random.default_rng(23)
    reads = oracle.random_reads(rng, 30, 20, 60) * 3
    cfg = KmerConfig(k=15, m=7, lower=1, upper=100, pad_multiple=128)
    got, _ = _run(reads, cfg, n_dev=2)
    assert got == _expect(reads, cfg)


def test_sharded_fewer_reads_than_shards():
    reads = ["ACGTACGTACGTACGTACGTACGTACGTACGTACGT"]
    cfg = KmerConfig(k=31, m=17, lower=1, upper=10, pad_multiple=128)
    got, _ = _run(reads, cfg)
    assert got == _expect(reads, cfg)


def test_each_kmer_counted_on_exactly_one_shard():
    # Duplicated reads across different shards must still merge counts:
    # without a correct exchange, each shard would count its local copy as 1.
    read = "".join(
        np.random.default_rng(5).choice(list("ACGT"), size=64)
    )
    reads = [read] * 8  # one copy lands on each shard
    cfg = KmerConfig(k=31, m=17, lower=8, upper=8, pad_multiple=128)
    got, _ = _run(reads, cfg)
    want = _expect(reads, cfg)
    assert got == want
    assert len(got) > 0  # every distinct kmer should have count exactly 8


@pytest.mark.parametrize("combiner", [False, True])
def test_minimizer_routing_matches_oracle(combiner):
    rng = np.random.default_rng(29)
    reads = oracle.random_reads(rng, 40, 35, 90)
    reads = reads + reads[:18]
    cfg = KmerConfig(
        k=31, m=17, lower=2, upper=50, routing="minimizer",
        combiner=combiner, avg_buckets_per_shard=3, pad_multiple=256,
        capacity_factor=3.0,
    )
    got, hist = _run(reads, cfg)
    want = _expect(reads, cfg)
    assert got == want


def test_range_capacity_tracks_mean_at_any_shape():
    """Wire capacity must stay ~= mean + mean/64 at EVERY n_local, not just
    pow2-snapped ones: a rule rounding the mean up to a pow2 first would,
    at a mean just above a boundary, ship 2.03x n_local and merge 4x."""
    from hysortk_tpu.parallel.pipeline import range_capacity
    from hysortk_tpu.ops import spill

    cfg = KmerConfig(k=31, m=17, lower=2, upper=50)
    for n_local in (1 << 21, (1 << 21) + 4096, int((1 << 21) * 1.5),
                    (1 << 22) - 512, 100_000):
        for s in (2, 8):
            cap = range_capacity(n_local, s, cfg)
            mean = -(-n_local // s)
            # Margin present (hash fluctuation ~ sqrt(mean) must fit) ...
            assert cap - mean >= max(min(mean // 64, cap - mean), 64) or \
                cap >= mean + 4 * int(mean ** 0.5)
            # ... but never the 2x pow2 blowup.
            assert cap <= mean + max(mean // 64, 64), (n_local, s, cap)
            m, sc = spill.split_capacity(cap)
            # The receive merge geometry (2m per run) stays within ~2x mean.
            assert 2 * m <= 4 * mean


def test_narrow_counts_exact_roundtrip():
    """Filtered counts cast to the narrowest dtype upper fits; values are
    exact and the host side restores int32."""
    from hysortk_tpu.pipeline import narrow_counts

    cnt = jax.numpy.asarray(
        np.array([1, 2, 50, 255, 65535, 0], dtype=np.uint32)
    )
    for upper, dtype in ((50, np.uint8), (255, np.uint8),
                         (65535, np.uint16), (1 << 20, np.uint32)):
        out = np.asarray(narrow_counts(cnt, upper))
        assert out.dtype == dtype, (upper, out.dtype)
        mask = np.asarray(cnt) <= upper
        np.testing.assert_array_equal(
            out.astype(np.uint32)[mask], np.asarray(cnt)[mask]
        )
