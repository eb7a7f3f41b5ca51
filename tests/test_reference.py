"""The vectorized numpy reference and the output-file parser, against the
brute-force dict oracle."""

import numpy as np
import pytest

from hysortk_tpu import testing as oracle
from hysortk_tpu.io import fasta as fasta_io
from hysortk_tpu.io import writer
from hysortk_tpu.ops import kmer as kmer_ops
from hysortk_tpu.pipeline import KmerList

KS = (15, 16, 17, 31, 32, 33, 55, 63, 64, 96)


def _reads(kind: str, seed: int) -> list[str]:
    rng = np.random.default_rng(seed)
    if kind == "short":
        reads = oracle.random_reads(rng, 60, 10, 160)
        return reads + reads[:20]
    # Long reads sharing a repeated segment, plus reads shorter than k.
    unit = oracle.random_reads(rng, 1, 300, 300)[0]
    reads = oracle.random_reads(rng, 3, 2000, 4000)
    return [r[:700] + unit + r[700:] for r in reads] + ["ACGTN" * 3, unit]


@pytest.mark.parametrize("kind", ["short", "long"])
@pytest.mark.parametrize("k", KS)
def test_reference_matches_oracle(k, kind):
    reads = _reads(kind, k)
    codes, lengths = fasta_io.reads_to_codes(reads)
    ref = oracle.reference_count(codes, lengths, k, 2, 60, chunk=1 << 12)
    want = oracle.oracle_filtered(reads, k, 2, 60)
    decoded = [s.decode() for s in kmer_ops.decode_keys(ref.keys, k)]
    assert dict(zip(decoded, ref.counts.tolist())) == want
    assert decoded == sorted(decoded)
    all_counts = oracle.oracle_counts(reads, k)
    assert ref.n_distinct == len(all_counts)
    assert ref.n_kmers == sum(all_counts.values())
    hist = np.zeros(61, np.int64)
    for c in want.values():
        hist[c] += 1
    assert np.array_equal(ref.hist, hist)


@pytest.mark.parametrize("k", [15, 31, 55])
def test_read_output_file_roundtrip(tmp_path, k):
    reads = _reads("short", 100 + k)
    codes, lengths = fasta_io.reads_to_codes(reads)
    ref = oracle.reference_count(codes, lengths, k, 1, 1000)
    # Counts with up to four digits exercise the variable-width parse.
    counts = (ref.counts * 997 % 9999 + 1).astype(np.int32)
    writer.write_output_file(KmerList(ref.keys, counts, k), str(tmp_path))
    keys, got = oracle.read_output_file(str(tmp_path / "0.out"), k)
    assert oracle.same_counts(keys, got, ref.keys, counts)
    assert not oracle.same_counts(keys, got + 1, ref.keys, counts)
