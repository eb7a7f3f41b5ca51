"""Tests that need an NVIDIA GPU. They skip elsewhere; on the card run
`JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`."""

import numpy as np
import pytest

import hysortk_tpu as H
from hysortk_tpu import testing


@pytest.mark.gpu
def test_count_on_gpu(gpu):
    sim = testing.simulate_reads(5, genome_len=200_000, n_families=10)
    cfg = H.KmerConfig(k=31, m=17, lower=2, upper=50)
    got, hist = H.kmer_count(sim.codes(), sim.lengths, cfg, single_device=True)
    ref = testing.reference_count(sim.codes(), sim.lengths, 31, 2, 50)
    assert testing.same_counts(got.keys, got.counts, ref.keys, ref.counts)
    assert np.array_equal(hist, ref.hist)
