"""Supermer-dispatch pipeline (parallel/supermer_route.py) vs the oracle.

The reference's exchange architecture: supermers move (lengths + 2-bit
bases), keys never do; each shard counts only the buckets it owns
(reference src/kmerops.cpp:1096-1148, 587-643, 484-521)."""

import numpy as np
import pytest

import jax

from hysortk_tpu import KmerConfig
from hysortk_tpu.io import fasta as fasta_io
from hysortk_tpu.io import supermer as supermer_io
from hysortk_tpu.parallel.mesh import make_mesh
from hysortk_tpu.parallel import supermer_route
from hysortk_tpu import testing as oracle

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs multi-device (virtual CPU) mesh"
)


def _run(reads, cfg, n_dev=None):
    devs = jax.devices()[: n_dev or len(jax.devices())]
    mesh = make_mesh(devs)
    codes, lengths = fasta_io.reads_to_codes(reads)
    kmerlist, hist = supermer_route.count_reads_supermer(
        codes, lengths, cfg, mesh
    )
    return kmerlist.as_dict(), hist


def _expect(reads, cfg):
    filt = oracle.oracle_filtered(reads, cfg.k, cfg.lower, cfg.upper)
    return {k.encode(): v for k, v in filt.items()}


@pytest.mark.parametrize("dispatcher", ["balanced", "round_robin"])
def test_supermer_route_matches_oracle(dispatcher):
    rng = np.random.default_rng(23)
    reads = oracle.random_reads(rng, 40, 35, 120)
    reads = reads + reads[:20] + reads[:6]
    cfg = KmerConfig(k=31, m=17, lower=2, upper=50, routing="supermer",
                     dispatcher=dispatcher, pad_multiple=256)
    got, hist = _run(reads, cfg)
    want = _expect(reads, cfg)
    assert got == want
    counts = np.asarray(sorted(want.values()))
    np.testing.assert_array_equal(
        np.bincount(counts, minlength=cfg.upper + 1)[: cfg.upper + 1], hist
    )


def test_supermer_route_k15_one_word_keys():
    rng = np.random.default_rng(5)
    reads = oracle.random_reads(rng, 30, 20, 70) * 3
    cfg = KmerConfig(k=15, m=7, lower=2, upper=60, routing="supermer",
                     pad_multiple=256)
    assert _run(reads, cfg, n_dev=4)[0] == _expect(reads, cfg)


def test_supermer_route_via_count_reads_sharded():
    from hysortk_tpu.parallel.pipeline import count_reads_sharded

    rng = np.random.default_rng(9)
    reads = oracle.random_reads(rng, 24, 40, 80) * 2
    cfg = KmerConfig(k=31, m=11, lower=1, upper=500, routing="supermer")
    codes, lengths = fasta_io.reads_to_codes(reads)
    kmerlist, _ = count_reads_sharded(codes, lengths, cfg, make_mesh())
    assert kmerlist.as_dict() == _expect(reads, cfg)


def test_supermer_streams_roundtrip_and_density():
    """Stream encoding must (a) cover every valid k-mer exactly once across
    buckets, (b) ship ~2 bits/base + 4 B/supermer — the reference wire
    density (src/kmerops.cpp:1096-1148) — far below raw packed keys."""
    rng = np.random.default_rng(31)
    reads = oracle.random_reads(rng, 60, 80, 400)
    cfg = KmerConfig(k=31, m=17, lower=1, upper=65535)
    codes, lengths = fasta_io.reads_to_codes(reads)
    flat_codes, flat_valid = fasta_io.flatten_for_device(
        codes, lengths, cfg.k, 256
    )
    S = 8
    dest = supermer_route.host_destinations(flat_codes, cfg.k, cfg.m, S)
    streams = supermer_io.encode_supermer_streams(
        flat_codes, flat_valid, dest, cfg.k, S
    )
    # Every decoded window is a valid k-mer; multiset across buckets equals
    # the oracle's unfiltered canonical counts.
    from collections import Counter

    got = Counter()
    b2c = {0: "A", 1: "C", 2: "G", 3: "T"}
    for c, ln in streams:
        off = 0
        for l in ln:
            seq = "".join(b2c[int(x)] for x in c[off : off + int(l)])
            assert int(l) <= supermer_io.MAX_SUPERMER_LEN
            for i in range(int(l) - cfg.k + 1):
                got[oracle.canonical(seq[i : i + cfg.k])] += 1
            off += int(l)
    assert got == oracle.oracle_counts(reads, cfg.k)

    total_kmers = sum(got.values())
    wire = supermer_route.wire_nbytes(streams)
    raw = total_kmers * cfg.words * 4
    assert wire < raw / 4, (wire, raw)
    total_supermer_bases = sum(int(l.sum()) for _, l in streams)
    n_supermers = sum(l.size for _, l in streams)
    assert wire <= total_supermer_bases / 4 + 4 * n_supermers + 8


def test_supermer_route_extension_occurrences():
    """EXT under supermer routing: {len, pos, rid} run headers on the wire
    (reference include/kmer.hpp:348-360), per-kmer (rid, pos) derived on
    device with diff-scatter scans (ops/wire.fill_run_meta)."""
    rng = np.random.default_rng(55)
    reads = oracle.random_reads(rng, 28, 35, 100)
    reads = reads + reads[:14] + reads[:4]
    cfg = KmerConfig(k=31, m=17, lower=2, upper=50, routing="supermer",
                     extension=True, pad_multiple=256)
    codes, lengths = fasta_io.reads_to_codes(reads)
    kl, hist = supermer_route.count_reads_supermer_ext(
        codes, lengths, cfg, make_mesh()
    )
    occ = oracle.oracle_occurrences(reads, cfg.k)
    filt = oracle.oracle_filtered(reads, cfg.k, cfg.lower, cfg.upper)
    got = {
        km.decode(): set((int(r), int(p)) for r, p in zip(rr, pp))
        for km, rr, pp in zip(kl.decoded(), kl.rid, kl.pos)
    }
    assert got == {km: occ[km] for km in filt}
    counts = np.asarray(sorted(filt.values()))
    np.testing.assert_array_equal(
        np.bincount(counts, minlength=cfg.upper + 1)[: cfg.upper + 1], hist
    )


def test_supermer_ext_via_count_reads_sharded_ext():
    from hysortk_tpu.parallel.pipeline import count_reads_sharded_ext

    rng = np.random.default_rng(57)
    reads = oracle.random_reads(rng, 20, 40, 90) * 2
    cfg = KmerConfig(k=15, m=7, lower=1, upper=500, routing="supermer",
                     extension=True, pad_multiple=256)
    codes, lengths = fasta_io.reads_to_codes(reads)
    kl, _ = count_reads_sharded_ext(codes, lengths, cfg, make_mesh())
    occ = oracle.oracle_occurrences(reads, cfg.k)
    got = {
        km.decode(): set((int(r), int(p)) for r, p in zip(rr, pp))
        for km, rr, pp in zip(kl.decoded(), kl.rid, kl.pos)
    }
    assert got == occ


@pytest.mark.parametrize("n_dev", [2, 8])
def test_supermer_exchange_matches_oracle(n_dev):
    """On-fabric variant: supermer segments cross the mesh in one
    all_to_all and the owner shard decodes them (reference exchange +
    receive-side parse, src/kmerops.cpp:587-643, 484-521)."""
    rng = np.random.default_rng(41)
    reads = oracle.random_reads(rng, 36, 35, 110)
    reads = reads + reads[:18] + reads[:5]
    cfg = KmerConfig(k=31, m=17, lower=2, upper=50, routing="supermer",
                     pad_multiple=256)
    devs = jax.devices()[:n_dev]
    mesh = make_mesh(devs)
    codes, lengths = fasta_io.reads_to_codes(reads)
    kmerlist, hist = supermer_route.count_reads_supermer_exchange(
        codes, lengths, cfg, mesh
    )
    assert kmerlist.as_dict() == _expect(reads, cfg)
    direct, hist_direct = _run(reads, cfg, n_dev=n_dev)
    assert kmerlist.as_dict() == direct
    np.testing.assert_array_equal(hist, hist_direct)


def test_split_stream_boundaries():
    ln = np.asarray([40, 35, 60, 31, 31], dtype=np.uint32)
    c = np.arange(int(ln.sum()), dtype=np.int8)
    parts = supermer_route.split_stream(c, ln, 3)
    assert sum(p[1].size for p in parts) == ln.size
    got_c = np.concatenate([p[0] for p in parts])
    got_l = np.concatenate([p[1] for p in parts])
    np.testing.assert_array_equal(got_c, c)
    np.testing.assert_array_equal(got_l, ln)
    for pc, pl in parts:
        assert pc.size == int(pl.sum())
    # Empty stream and parts > supermers must still tile exactly.
    parts = supermer_route.split_stream(
        np.zeros(0, np.int8), np.zeros(0, np.uint32), 4
    )
    assert len(parts) == 4 and all(p[1].size == 0 for p in parts)
    parts = supermer_route.split_stream(c[:40], ln[:1], 3)
    assert sum(p[1].size for p in parts) == 1
    assert sum(p[0].size for p in parts) == 40


def test_supermer_exchange_extension_occurrences():
    """EXT over the on-fabric supermer exchange: run headers ride the same
    all_to_all; owner shards derive per-kmer (rid, pos) post-exchange."""
    rng = np.random.default_rng(61)
    reads = oracle.random_reads(rng, 24, 35, 100)
    reads = reads + reads[:12]
    cfg = KmerConfig(k=31, m=17, lower=2, upper=50, routing="supermer",
                     extension=True, pad_multiple=256)
    codes, lengths = fasta_io.reads_to_codes(reads)
    kl, hist = supermer_route.count_reads_supermer_exchange(
        codes, lengths, cfg, make_mesh()
    )
    occ = oracle.oracle_occurrences(reads, cfg.k)
    filt = oracle.oracle_filtered(reads, cfg.k, cfg.lower, cfg.upper)
    got = {
        km.decode(): set((int(r), int(p)) for r, p in zip(rr, pp))
        for km, rr, pp in zip(kl.decoded(), kl.rid, kl.pos)
    }
    assert got == {km: occ[km] for km in filt}
    # Equality with the direct-dispatch EXT path.
    kl2, hist2 = supermer_route.count_reads_supermer_ext(
        codes, lengths, cfg, make_mesh()
    )
    assert kl.as_dict() == kl2.as_dict()
    np.testing.assert_array_equal(hist, hist2)


def test_supermer_heavy_hitter_precount():
    """One k-mer at ~30% abundance: the
    classifier must strip its bucket from the streams — bounding the
    padded per-shard block — and its pre-counted entries must surface with
    exact counts through both transports."""
    from hysortk_tpu.parallel import dispatch

    rng = np.random.default_rng(67)
    base = oracle.random_reads(rng, 30, 40, 100)
    # Poly-A reads: every window is the same canonical k-mer.
    heavy = ["A" * 300] * 6
    reads = base + heavy
    cfg = KmerConfig(k=31, m=17, lower=1, upper=2**15, routing="supermer",
                     classifier="heavy_hitter", pad_multiple=256)
    codes, lengths = fasta_io.reads_to_codes(reads)
    mesh = make_mesh(jax.devices())

    # The classifier must flag the poly-A bucket on this input.
    flat_c, flat_v = fasta_io.flatten_for_device(
        codes, lengths, cfg.k, cfg.pad_multiple
    )
    nb = 8 * cfg.avg_buckets_per_shard
    dest = supermer_route.host_destinations(flat_c, cfg.k, cfg.m, nb)
    sizes = np.bincount(dest[flat_v.astype(bool)], minlength=nb)
    types = dispatch.classify(sizes.astype(np.int64), cfg.heavy_ratio)
    assert (types == dispatch.HEAVY).any(), "input failed to trip classify"

    # Block boundedness: the packed block must shrink vs classifier off.
    blocks = {}
    orig = supermer_route._pack_streams

    def spy(streams, pad):
        out = orig(streams, pad)
        blocks[len(blocks)] = out[2]
        return out

    supermer_route._pack_streams = spy
    try:
        kl, hist = supermer_route.count_reads_supermer(
            codes, lengths, cfg, mesh
        )
        block_heavy = blocks[0]
        import dataclasses

        cfg_off = dataclasses.replace(cfg, classifier="plain")
        kl_off, hist_off = supermer_route.count_reads_supermer(
            codes, lengths, cfg_off, mesh
        )
        block_off = blocks[1]
    finally:
        supermer_route._pack_streams = orig
    assert block_heavy < block_off, (block_heavy, block_off)

    want = _expect(reads, cfg)
    assert kl.as_dict() == want
    assert kl_off.as_dict() == want
    np.testing.assert_array_equal(hist, hist_off)

    # Exchange transport (single-process on the CPU mesh).
    kl2, hist2 = supermer_route.count_reads_supermer_exchange(
        codes, lengths, cfg, mesh
    )
    assert kl2.as_dict() == want
    np.testing.assert_array_equal(hist2, hist)


def test_supermer_heavy_filter_bounds_apply_to_entries():
    """[L,U] must filter the host-side pre-counted entries too: the heavy
    key's total exceeds upper here and must be dropped."""
    rng = np.random.default_rng(68)
    reads = oracle.random_reads(rng, 20, 40, 80) * 2 + ["A" * 200] * 4
    cfg = KmerConfig(k=31, m=17, lower=2, upper=50, routing="supermer",
                     classifier="heavy_hitter", pad_multiple=256)
    codes, lengths = fasta_io.reads_to_codes(reads)
    kl, _ = supermer_route.count_reads_supermer(
        codes, lengths, cfg, make_mesh(jax.devices())
    )
    assert kl.as_dict() == _expect(reads, cfg)
    assert b"A" * 31 not in kl.as_dict()


@pytest.mark.parametrize("n_dev", [2, 8])
def test_supermer_streaming_matches_one_shot(n_dev):
    """Bounded-memory supermer streaming == one-shot dispatch: small
    batch_bases forces many batches; keys stay
    owner-fixed via the batch-0 assignment."""
    rng = np.random.default_rng(71)
    reads = oracle.random_reads(rng, 50, 35, 110)
    reads = reads + reads[:25]
    cfg = KmerConfig(k=31, m=17, lower=2, upper=50, routing="supermer",
                     pad_multiple=256)
    codes, lengths = fasta_io.reads_to_codes(reads)
    mesh = make_mesh(jax.devices()[:n_dev])
    kl1, h1 = supermer_route.count_reads_supermer(codes, lengths, cfg, mesh)
    kl2, h2 = supermer_route.count_reads_supermer_streaming(
        codes, lengths, cfg, batch_bases=1200, mesh=mesh
    )
    assert kl1.as_dict() == kl2.as_dict() == _expect(reads, cfg)
    np.testing.assert_array_equal(h1, h2)


def test_supermer_streaming_heavy_toggle():
    """Heavy classification may differ between batches (the poly-A block
    only appears in later batches); host entries and raw partials for the
    same key must still sum exactly in the final merge."""
    rng = np.random.default_rng(73)
    base = oracle.random_reads(rng, 30, 40, 90)
    reads = base + ["A" * 250] * 5 + base[:10]
    cfg = KmerConfig(k=31, m=17, lower=1, upper=2**15, routing="supermer",
                     classifier="heavy_hitter", pad_multiple=256)
    codes, lengths = fasta_io.reads_to_codes(reads)
    mesh = make_mesh(jax.devices())
    kl, _ = supermer_route.count_reads_supermer_streaming(
        codes, lengths, cfg, batch_bases=900, mesh=mesh
    )
    assert kl.as_dict() == _expect(reads, cfg)


def test_supermer_streaming_ext_delegates():
    """EXT + supermer + streaming: per-batch unfiltered supermer EXT
    passes, occurrence partials merged host-side."""
    rng = np.random.default_rng(77)
    reads = oracle.random_reads(rng, 24, 35, 90)
    reads = reads + reads[:12]
    cfg = KmerConfig(k=31, m=17, lower=2, upper=50, routing="supermer",
                     extension=True, pad_multiple=256)
    codes, lengths = fasta_io.reads_to_codes(reads)
    mesh = make_mesh(jax.devices())
    kl, hist = supermer_route.count_reads_supermer_streaming(
        codes, lengths, cfg, batch_bases=1100, mesh=mesh
    )
    occ = oracle.oracle_occurrences(reads, cfg.k)
    filt = oracle.oracle_filtered(reads, cfg.k, cfg.lower, cfg.upper)
    got = {
        km.decode(): set((int(r), int(p)) for r, p in zip(rr, pp))
        for km, rr, pp in zip(kl.decoded(), kl.rid, kl.pos)
    }
    assert got == {km: occ[km] for km in filt}


def test_multihost_supermer_ext_streaming_single_process(tmp_path):
    """EXT through the bounded supermer exchange rounds (the last routing x
    mode x scale matrix cell): per-batch {len, pos, rid} run headers ride
    the all_to_all, unfiltered occurrence partials merge host-side. Must
    equal the occurrence oracle and the one-shot EXT exchange."""
    rng = np.random.default_rng(83)
    reads = oracle.random_reads(rng, 36, 35, 95)
    reads = reads + reads[:14]
    fasta = tmp_path / "smes.fa"
    with open(fasta, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n{r}\n")
    cfg = KmerConfig(k=31, m=17, lower=2, upper=50, routing="supermer",
                     extension=True, pad_multiple=128)
    kl, hist = supermer_route.count_fasta_multihost_supermer_streaming(
        str(fasta), cfg, batch_bases=1000
    )
    occ = oracle.oracle_occurrences(reads, cfg.k)
    filt = oracle.oracle_filtered(reads, cfg.k, cfg.lower, cfg.upper)
    got = {
        km.decode(): set((int(r), int(p)) for r, p in zip(rr, pp))
        for km, rr, pp in zip(kl.decoded(), kl.rid, kl.pos)
    }
    assert got == {km: occ[km] for km in filt}
    kl1, hist1 = supermer_route.count_fasta_multihost_supermer(
        str(fasta), cfg
    )
    got1 = {
        km.decode(): set((int(r), int(p)) for r, p in zip(rr, pp))
        for km, rr, pp in zip(kl1.decoded(), kl1.rid, kl1.pos)
    }
    assert got == got1
    np.testing.assert_array_equal(hist, hist1)


def test_multihost_supermer_streaming_single_process(tmp_path):
    """count_fasta_multihost_supermer_streaming degenerates to bounded
    single-process rounds; must equal the one-shot exchange result."""
    rng = np.random.default_rng(79)
    reads = oracle.random_reads(rng, 40, 40, 100)
    reads = reads + reads[:16]
    fasta = tmp_path / "sms.fa"
    with open(fasta, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n{r}\n")
    cfg = KmerConfig(k=31, m=17, lower=2, upper=50, routing="supermer",
                     pad_multiple=128)
    kl, hist = supermer_route.count_fasta_multihost_supermer_streaming(
        str(fasta), cfg, batch_bases=1000
    )
    assert kl.as_dict() == _expect(reads, cfg)
    kl1, hist1 = supermer_route.count_fasta_multihost_supermer(
        str(fasta), cfg
    )
    assert kl.as_dict() == kl1.as_dict()
    np.testing.assert_array_equal(hist, hist1)
