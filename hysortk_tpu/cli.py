"""Command-line interface: `python -m hysortk_tpu.cli <fasta> [output_dir]`.

Mirrors the reference standalone binary (reference: standalone/main.cpp:9-72):
prints the parameter block, runs read -> count -> histogram -> output files.
Extra flags expose what the reference fixes at compile time.
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="hysortk_tpu",
        description="sorting-based k-mer counter on JAX devices",
    )
    p.add_argument("fasta", help="input FASTA file (a .fai is built if absent)")
    p.add_argument(
        "output_dir",
        nargs="?",
        default=None,
        help="directory for per-shard {kmer}\\t{count} files (omit to skip)",
    )
    p.add_argument("-k", type=int, default=31, help="k-mer size (default 31)")
    p.add_argument("-m", type=int, default=17, help="minimizer size (default 17)")
    p.add_argument("-l", "--lower", type=int, default=15,
                   help="lower frequency bound (default 15)")
    p.add_argument("-u", "--upper", type=int, default=40,
                   help="upper frequency bound (default 40)")
    p.add_argument("--combiner", action="store_true",
                   help="pre-aggregate local duplicates before the exchange")
    p.add_argument("--routing",
                   choices=("range", "kmer_hash", "minimizer", "supermer"),
                   default="range",
                   help="multi-device destination rule: range = sort-once "
                        "range partition in mixed key space (default); "
                        "minimizer = the reference's virtual-task scheme + "
                        "balanced dispatch; supermer = host-side supermer "
                        "dispatch (~2 bit/base wire, no device exchange); "
                        "kmer_hash = legacy hash-mod")
    p.add_argument("--classifier", choices=("heavy_hitter", "plain"),
                   default="heavy_hitter",
                   help="heavy_hitter: measurement pass pre-sizes exchange "
                        "capacity and auto-enables the combiner on skew")
    p.add_argument("--dispatcher", choices=("balanced", "round_robin"),
                   default="balanced",
                   help="bucket placement under minimizer routing")
    p.add_argument("--profile", metavar="LOGDIR", default=None,
                   help="capture a jax.profiler trace of the counting stage")
    p.add_argument("--device-compact", action="store_true",
                   help="compact results on device and pull exact-size "
                        "slices (costs one extra device sort per batch)")
    p.add_argument("--single-device", action="store_true",
                   help="run on one device even on a multi-device host")
    p.add_argument("--extension", action="store_true",
                   help="EXT mode: carry (ReadId, PosInRead) payloads")
    p.add_argument("--stream-batch-bases", type=int, default=0,
                   help="stream the input in device batches of this many "
                        "bases (0 = one shot); bounds HBM usage")
    p.add_argument("--coordinator", default=None,
                   help="multi-host: coordinator address for jax.distributed")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--no-histogram", action="store_true")
    p.add_argument("--repeat", type=int, default=1,
                   help="run the counting stage N times in one process "
                        "(timing: later runs measure the steady state "
                        "with compiles amortized)")
    p.add_argument(
        "--validate", action="store_true",
        help="after counting, cross-check the result against a brute-force "
             "host oracle (runtime sanitizer; inputs up to ~4 Mb — larger "
             "inputs are refused, use the golden test harness instead)")
    return p


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)

    import os as _os_log

    # HYSORTK_LOG=info (or debug) surfaces the internal stage logs — the
    # streaming scheduler stamps drain/consolidation/pull spans with byte
    # counts.
    lvl = _os_log.environ.get("HYSORTK_LOG")
    if lvl:
        import logging as _logging

        _logging.basicConfig(
            level=getattr(_logging, lvl.upper(), _logging.INFO),
            format="%(asctime)s %(name)s %(message)s",
        )

    import jax

    from .runtime.compile_cache import setup_compile_cache

    setup_compile_cache()

    from . import kmer_count, print_kmer_histogram, read_dna_buffer, write_output_file
    from .config import KmerConfig
    from .runtime.logger import Logger
    from .runtime.timer import Timer

    cfg = KmerConfig(
        k=args.k, m=args.m, lower=args.lower, upper=args.upper,
        combiner=args.combiner,
        extension=args.extension, routing=args.routing,
        classifier=args.classifier, dispatcher=args.dispatcher,
        device_compact=args.device_compact,
    )

    if cfg.routing == "supermer" and args.single_device:
        p.error(
            "--routing supermer is a sharded dispatch path; it does not "
            "combine with --single-device (use the default range routing "
            "there)"
        )
    if args.coordinator:
        from .parallel.multihost import initialize_distributed

        initialize_distributed(
            args.coordinator, args.num_processes, args.process_id
        )

    log = Logger()
    devices = jax.devices()
    multiproc = jax.process_count() > 1
    log.root(f"hysortk_tpu | k={cfg.k} m={cfg.m} L={cfg.lower} U={cfg.upper} "
             f"combiner={cfg.combiner}")
    log.root(f"devices: {len(devices)} x {devices[0].device_kind}")
    log.root(f"input: {args.fasta}")

    # Synchronized spans across processes, like the reference Timer's
    # barrier + MPI_Wtime (include/timer.hpp:24-68).
    timer = Timer(synchronized=multiproc)
    with timer.span("read_fasta"):
        codes, lengths = read_dna_buffer(args.fasta)
    log.root(f"{lengths.size} reads, {codes.size} bases "
             f"({codes.size / max(timer.last('read_fasta'), 1e-9) / 1e6:.1f} Mb/s)")

    import contextlib

    if args.profile:
        from .runtime.profiling import trace as profile_trace

        profile_cm = profile_trace(args.profile)
    else:
        profile_cm = contextlib.nullcontext()

    def _do_count():
        if args.extension:
            if args.stream_batch_bases:
                # Bounded-memory EXT: per-batch unfiltered occurrence
                # partials merged host-side (the reference's EXT-indifferent
                # bounded round loop, src/kmerops.cpp:906-1007).
                if jax.process_count() > 1:
                    if cfg.routing == "supermer":
                        # Supermer wire with EXT {len, pos, rid} run
                        # headers, bounded rounds across the fabric.
                        from .parallel.supermer_route import (
                            count_fasta_multihost_supermer_streaming,
                        )

                        kmerlist, hist = (
                            count_fasta_multihost_supermer_streaming(
                                args.fasta, cfg, args.stream_batch_bases
                            )
                        )
                    else:
                        from .parallel.multihost import (
                            count_fasta_multihost_ext_streaming,
                        )

                        kmerlist, hist = count_fasta_multihost_ext_streaming(
                            args.fasta, cfg, args.stream_batch_bases
                        )
                elif len(devices) > 1 and not args.single_device:
                    from .parallel.pipeline import (
                        count_reads_sharded_ext_streaming,
                    )

                    kmerlist, hist = count_reads_sharded_ext_streaming(
                        codes, lengths, cfg, args.stream_batch_bases
                    )
                else:
                    from .runtime.scheduler import count_reads_streaming_ext

                    kmerlist, hist = count_reads_streaming_ext(
                        codes, lengths, cfg, args.stream_batch_bases
                    )
            elif jax.process_count() > 1:
                if cfg.routing == "supermer":
                    # The supermer wire carries EXT {len,pos,rid} run
                    # headers; count_fasta_multihost_ext would silently
                    # fall back to the hash-mod exchange for this routing.
                    from .parallel.supermer_route import (
                        count_fasta_multihost_supermer,
                    )

                    kmerlist, hist = count_fasta_multihost_supermer(
                        args.fasta, cfg
                    )
                else:
                    from .parallel.multihost import count_fasta_multihost_ext

                    kmerlist, hist = count_fasta_multihost_ext(args.fasta, cfg)
            elif len(devices) > 1 and not args.single_device:
                from .parallel.pipeline import count_reads_sharded_ext

                kmerlist, hist = count_reads_sharded_ext(codes, lengths, cfg)
            else:
                kmerlist, hist = kmer_count(
                    codes, lengths, cfg, single_device=True
                )
        elif args.stream_batch_bases:
            if jax.process_count() > 1:
                from .parallel.multihost import count_fasta_multihost_streaming

                kmerlist, hist = count_fasta_multihost_streaming(
                    args.fasta, cfg, args.stream_batch_bases
                )
            elif cfg.routing == "supermer":
                from .parallel.supermer_route import (
                    count_reads_supermer_streaming,
                )

                kmerlist, hist = count_reads_supermer_streaming(
                    codes, lengths, cfg, args.stream_batch_bases
                )
            elif len(devices) > 1 and not args.single_device:
                from .parallel.pipeline import count_reads_sharded_streaming

                kmerlist, hist = count_reads_sharded_streaming(
                    codes, lengths, cfg, args.stream_batch_bases
                )
            else:
                from .runtime.scheduler import count_reads_streaming

                kmerlist, hist = count_reads_streaming(
                    codes, lengths, cfg, args.stream_batch_bases
                )
        elif jax.process_count() > 1:
            if cfg.routing == "supermer":
                from .parallel.supermer_route import (
                    count_fasta_multihost_supermer,
                )

                kmerlist, hist = count_fasta_multihost_supermer(
                    args.fasta, cfg
                )
            else:
                from .parallel.multihost import count_fasta_multihost

                kmerlist, hist = count_fasta_multihost(args.fasta, cfg)
        elif len(devices) > 1 and not args.single_device:
            from .parallel.pipeline import count_reads_sharded

            kmerlist, hist = count_reads_sharded(codes, lengths, cfg)
        else:
            kmerlist, hist = kmer_count(
                codes, lengths, cfg, single_device=True
            )
        return kmerlist, hist

    with profile_cm, timer.span("kmer_count"):
        kmerlist, hist = _do_count()
    # --repeat N: run the counting stage again in the SAME process; the
    # repeat spans time the steady state with compiles amortized away.
    for r in range(1, args.repeat):
        # Drop every reference to the previous pass's device buffers and
        # give the (asynchronous) backend deallocator a beat, so pass 2's
        # peak does not land on top of pass 1's not-yet-freed tail.
        import gc

        kmerlist = hist = None
        gc.collect()
        import jax as _jax

        _jax.device_get(_jax.numpy.zeros(8))
        with timer.span(f"kmer_count_rep{r}"):
            kmerlist, hist = _do_count()
    # With --repeat, report the LAST completed span (the steady-state time
    # the flag exists to measure), not the compile/load-dominated pass 0.
    last_span = (
        f"kmer_count_rep{args.repeat - 1}" if args.repeat > 1 else "kmer_count"
    )
    log.root(f"{len(kmerlist)} filtered kmers in "
             f"{timer.last(last_span):.3f}s ({last_span})")

    if args.validate:
        # Runtime sanitizer (the role ASan/UBSan builds play for the
        # reference): recount on the host with the brute-force oracle and
        # require exact {kmer: count} equality. Multi-process runs only
        # check this process's shard for containment + global size.
        if codes.size > 4 * 1024 * 1024:
            p.error("--validate is for inputs up to ~4 Mb")
        import numpy as np

        from . import testing as _oracle

        offs = np.concatenate([[0], np.cumsum(lengths)])
        b2c = np.frombuffer(b"ACGT", dtype=np.uint8)
        reads = [
            b2c[codes[offs[i]: offs[i + 1]]].tobytes().decode()
            for i in range(lengths.size)
        ]
        want = {
            km.encode(): c
            for km, c in _oracle.oracle_filtered(
                reads, cfg.k, cfg.lower, cfg.upper
            ).items()
        }
        got = kmerlist.as_dict()
        if multiproc:
            bad = {km for km, c in got.items() if want.get(km) != c}
            ok = not bad
        else:
            ok = got == want
        if not ok:
            log.root("VALIDATE FAILED: device result != host oracle")
            return 1
        log.root(f"validate OK ({len(got)} kmers vs host oracle)")

    if not args.no_histogram:
        print_kmer_histogram(hist)

    if args.output_dir:
        with timer.span("write_output"):
            # Multi-host: each process writes its own shard file, like the
            # reference's per-rank `<rank>.out` (src/hysortk.cpp:138-164).
            path = write_output_file(
                kmerlist, args.output_dir, shard=jax.process_index()
            )
        log.root(f"wrote {path}")

    log.root(timer.report())
    from .runtime import memcheck

    log.root(memcheck.gathered_memory_report())
    return 0


if __name__ == "__main__":
    sys.exit(main())
