"""hysortk_tpu — a distributed k-mer counting engine in JAX.

A from-scratch JAX/XLA redesign with the capabilities of
CornellHPC/HySortK (ICPP'24), a C++/MPI/OpenMP code. The public facade
mirrors the reference library API (reference: include/hysortk.hpp:10-16):

    read_dna_buffer       -> read + 2-bit pack a (shard of a) FASTA file
    kmer_count            -> canonical k-mer counting with [L, U] filtering
    print_kmer_histogram  -> frequency histogram in the reference format
    write_output_file     -> per-shard `{kmer}\\t{count}` files
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .config import KmerConfig
from .pipeline import (
    KmerList,
    KmerListExt,
    count_flat,
    count_flat_ext,
    count_reads,
    count_reads_ext,
)
from .io import fasta as _fasta
from .io import writer as _writer

__version__ = "0.1.0"

__all__ = [
    "KmerConfig",
    "KmerList",
    "KmerListExt",
    "read_dna_buffer",
    "kmer_count",
    "print_kmer_histogram",
    "write_output_file",
    "count_flat",
    "count_flat_ext",
    "count_reads",
    "count_reads_ext",
    "count_reads_sharded",
    "count_reads_sharded_ext",
    "count_reads_sharded_streaming",
    "count_reads_sharded_ext_streaming",
    "count_reads_streaming",
    "count_reads_streaming_ext",
    "count_fasta_multihost",
    "count_fasta_multihost_ext",
    "count_fasta_multihost_streaming",
    "count_fasta_multihost_ext_streaming",
    "count_reads_supermer",
    "count_reads_supermer_ext",
    "count_reads_supermer_exchange",
    "count_fasta_multihost_supermer",
]


def __getattr__(name):
    # Heavy submodules load lazily; the sharded/multihost entry points are
    # re-exported here for library users (facade parity with hysortk.hpp).
    if name in (
        "count_reads_sharded",
        "count_reads_sharded_ext",
        "count_reads_sharded_streaming",
        "count_reads_sharded_ext_streaming",
    ):
        from .parallel import pipeline as _pp

        return getattr(_pp, name)
    if name in (
        "count_reads_supermer",
        "count_reads_supermer_ext",
        "count_reads_supermer_exchange",
        "count_fasta_multihost_supermer",
    ):
        from .parallel import supermer_route as _sr

        return getattr(_sr, name)
    if name in (
        "count_fasta_multihost",
        "count_fasta_multihost_ext",
        "count_fasta_multihost_streaming",
        "count_fasta_multihost_ext_streaming",
    ):
        from .parallel import multihost as _mh

        return getattr(_mh, name)
    if name in ("count_reads_streaming", "count_reads_streaming_ext"):
        from .runtime import scheduler as _sched

        return getattr(_sched, name)
    raise AttributeError(name)


def read_dna_buffer(
    fasta_path: str, shard: int = 0, num_shards: int = 1
) -> tuple[np.ndarray, np.ndarray]:
    """Read this shard's portion of a FASTA file, 2-bit packed.

    Returns (codes uint8 flat, lengths int64). Facade analogue of
    hysortk::read_dna_buffer (src/hysortk.cpp:18-34).
    """
    records = _fasta.load_or_build_fai(fasta_path)
    parts = _fasta.partition_records(records, num_shards)
    mine = [records[i] for i in parts[shard]]
    return _fasta.read_records(fasta_path, mine)


def kmer_count(
    codes: np.ndarray,
    lengths: np.ndarray,
    config: Optional[KmerConfig] = None,
    single_device: bool = False,
) -> tuple[KmerList, np.ndarray]:
    """Count canonical k-mers. Facade analogue of hysortk::kmer_count
    (src/hysortk.cpp:36-95). Returns (filtered KmerList, histogram array).

    Runs sharded over every device of the host unless single_device is
    set. Falls back to bounded-memory streaming automatically when the
    one-shot working set would not fit device-memory headroom (the
    reference instead switches sorters on MemFree,
    src/kmerops.cpp:1344-1379). With config.extension the result is a
    KmerListExt carrying (ReadId, PosInRead) payloads."""
    import jax

    cfg = config or KmerConfig()
    n_dev = 1 if single_device else len(jax.devices())
    if cfg.extension:
        if n_dev > 1:
            from .parallel.pipeline import count_reads_sharded_ext

            return count_reads_sharded_ext(codes, lengths, cfg)
        return count_reads_ext(codes, lengths, cfg)
    from .runtime import memcheck

    headroom = memcheck.hbm_headroom_bytes()
    need = int(codes.size) * (4 + 2 * cfg.words * 4 + 8) * 2 // n_dev
    if headroom is not None and 0 < headroom < need:
        from .runtime.scheduler import suggest_batch_bases

        batch = suggest_batch_bases(cfg)
        if n_dev > 1:
            from .parallel.pipeline import count_reads_sharded_streaming

            return count_reads_sharded_streaming(
                codes, lengths, cfg, batch * n_dev
            )
        from .runtime.scheduler import count_reads_streaming

        return count_reads_streaming(codes, lengths, cfg, batch)
    if n_dev > 1:
        from .parallel.pipeline import count_reads_sharded

        return count_reads_sharded(codes, lengths, cfg)
    return count_reads(codes, lengths, cfg)


def print_kmer_histogram(hist: np.ndarray) -> str:
    """Render + print the frequency histogram (src/hysortk.cpp:98-136)."""
    text = _writer.format_histogram(hist)
    print(text, end="")
    return text


def write_output_file(
    kmerlist: KmerList, output_dir: str, shard: int = 0
) -> str:
    """Write `<outdir>/<shard>.out` (src/hysortk.cpp:138-164)."""
    return _writer.write_output_file(kmerlist, output_dir, shard)
