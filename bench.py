"""Benchmark: canonical k-mers counted per second on one GPU at K=31.

Prints ONE JSON line:
  {"metric": "kmers_per_sec_per_chip_k31", "value": N, "unit": "kmers/s",
   "device": {"platform": ..., "kind": ..., "count": ...},
   "card": "<nvidia-smi name, power.limit>", "methodology": ...}

The measured quantity is the plain device-side pipeline (canonical key
construction + lax.sort + run-length count + [L,U] filter, as jitted by
hysortk_tpu.pipeline) on a synthetic read set of 2^26 flat positions,
steady state: after one warm-up call, PIPE_DEPTH batches are queued through
JAX's async dispatch and synced once; the best of ROUNDS such measurements
is reported. Compilation is set-up and is not timed.

Without a GPU it prints nothing on stdout and exits 2: a CPU number under a
device metric's name would mean nothing.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

FLAT = 1 << 26
READ_LEN = 1024
PIPE_DEPTH = 8
ROUNDS = 3


def make_input(total_bases: int, read_len: int, k: int, seed: int = 0):
    """Synthetic reads, flat codes + validity, ~8% duplicated reads."""
    from hysortk_tpu.io import fasta as fasta_io

    rng = np.random.default_rng(seed)
    n_reads = total_bases // read_len
    reads = rng.integers(0, 4, size=(n_reads, read_len), dtype=np.int8)
    ndup = max(n_reads // 12, 1)
    reads[-ndup:] = reads[:ndup]
    lengths = np.full(n_reads, read_len, dtype=np.int64)
    return fasta_io.flatten_for_device(reads.reshape(-1), lengths, k, 8192)


def main() -> int:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU: JAX sees {dev.platform}", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]

    from hysortk_tpu.config import KmerConfig
    from hysortk_tpu.pipeline import _count_device
    from hysortk_tpu.runtime.compile_cache import setup_compile_cache

    setup_compile_cache()
    cfg = KmerConfig(k=31, m=17, lower=2, upper=50)
    codes, valid = make_input(FLAT - 8192, READ_LEN, cfg.k)
    n_kmers = int(valid.sum())
    codes_j = jax.device_put(codes)
    valid_j = jax.device_put(valid)

    def run():
        return _count_device(codes_j, valid_j, cfg.k, cfg.lower, cfg.upper)

    jax.block_until_ready(run())
    best = float("inf")
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        jax.block_until_ready([run() for _ in range(PIPE_DEPTH)])
        best = min(best, (time.perf_counter() - t0) / PIPE_DEPTH)
    print(json.dumps({
        "metric": "kmers_per_sec_per_chip_k31",
        "value": round(n_kmers / best),
        "unit": "kmers/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
        "methodology": f"{codes.size} flat positions, {n_kmers} k-mers; best "
                       f"of {ROUNDS} rounds of {PIPE_DEPTH} async batches",
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
