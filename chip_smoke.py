"""Smoke run of the k-mer counting path on an NVIDIA GPU.

    python chip_smoke.py               # one GPU, every default phase
    python chip_smoke.py --cards 4     # the sharded path on four GPUs only

Default phases, on one device:

  0. platform check (exits non-zero without a GPU), card name and power
     limit, JAX version, native host library (rebuilt here), compile cache;
  1. a simulated short-read WGS read set (5 Mb genome with repeat families,
     150-base reads at 30x, 0.5% substitutions, a few N runs) written as a
     60-column FASTA, and its numpy reference count (hysortk_tpu.testing);
  2. the CLI, one shot, K=31 on one device, against the reference;
  3. the CLI, streaming in 2^25-base batches, against phase 2 and the
     reference;
  4. the CLI at K=15 and K=55 on a 16 Mb prefix, against the reference;
  5. EXT mode at K=31 on a 4 Mb prefix, against testing.oracle_occurrences;
  6. per-stage device timings of the plain XLA pipeline at 2^26 elements
     and K=31: key build, sort, count + filter, weighted run-length sum, and
     the merge of sorted runs at the streaming and range-exchange shapes.

Every comparison is exact integer equality; any failure ends the run with a
non-zero exit. The last line of standard output is one JSON object naming
the device as JAX reports it.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
K, M, LOWER, UPPER = 31, 17, 2, 50
STREAM_BATCH = 1 << 25
STAGE_N = 1 << 26
COMPILE_EVENTS = (
    "/jax/core/compile/jaxpr_trace_duration",
    "/jax/core/compile/jaxpr_to_mlir_module_duration",
    "/jax/core/compile/backend_compile_duration",
)


class CompileClock:
    """Seconds JAX spent tracing, lowering and compiling (set-up time)."""

    def __init__(self):
        import jax

        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event in COMPILE_EVENTS:
            self.seconds += duration


def say(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(ok: bool, what: str) -> None:
    if not ok:
        fail(what)
    say(f"  ok: {what}")


# --- phase 0 -----------------------------------------------------------------


def phase0_platform(cards: int):
    import jax

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        print(
            f"chip_smoke: no GPU: JAX sees {dev.platform} ({dev.device_kind})",
            file=sys.stderr,
        )
        raise SystemExit(2)
    if len(devices) < cards:
        fail(f"--cards {cards} but JAX sees {len(devices)} devices")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    say("== phase 0: platform")
    say(f"nvidia-smi: {smi}")
    say(f"jax {jax.__version__}, {len(devices)} x {dev.device_kind}")

    from hysortk_tpu.runtime.compile_cache import setup_compile_cache

    say(f"compile cache: {setup_compile_cache()}")
    # Rebuild the host library for this machine (it is compiled with
    # -march=native); without a toolchain the numpy fallbacks serve.
    t0 = time.perf_counter()
    try:
        build = subprocess.run(
            ["make", "-B", "-C", os.path.join(HERE, "native")],
            capture_output=True, text=True, timeout=300,
        )
        built = build.returncode == 0
        if not built:
            say(f"native build failed ({build.returncode}): "
                f"{(build.stdout + build.stderr).strip()[-600:]}")
    except FileNotFoundError as e:
        built = False
        say(f"native build not possible: {e}")
    from hysortk_tpu.io import native

    say(f"host library: {'native ' + native.LIB_PATH if native.available() else 'numpy fallback'}"
        f" (built here: {built}, {time.perf_counter() - t0:.1f} s set-up)")
    return devices


# --- phase 1 -----------------------------------------------------------------


class ReadSet:
    """The simulated reads, their FASTA files and reference counts."""

    def __init__(self, seed: int, workdir: str):
        from hysortk_tpu import testing

        t0 = time.perf_counter()
        self.sim = testing.simulate_reads(seed)
        self.workdir = workdir
        self.fasta = self.write("reads", self.sim)
        r = self.sim.reads
        say("== phase 1: data")
        say(f"reads: {r.shape[0]} x {r.shape[1]} bases = {r.size} bases, "
            f"genome {self.sim.genome_len}, {self.sim.n_errors} substitutions "
            f"({self.sim.n_errors / r.size:.4%}), {self.sim.n_n_bases} N bases; "
            f"generated + written in {time.perf_counter() - t0:.1f} s")

    def write(self, name: str, sim) -> str:
        from hysortk_tpu import testing

        path = os.path.join(self.workdir, f"{name}.fa")
        testing.write_fasta(path, sim.reads)
        return path

    def reference(self, sim, k: int):
        from hysortk_tpu import testing

        t0 = time.perf_counter()
        ref = testing.reference_count(sim.codes(), sim.lengths, k, LOWER, UPPER)
        say(f"  numpy reference K={k}: {ref.n_kmers} k-mers, "
            f"{ref.n_distinct} distinct, {ref.keys.shape[0]} in "
            f"[{LOWER}, {UPPER}] ({time.perf_counter() - t0:.1f} s)")
        return ref


# --- phases 2-5: the CLI ----------------------------------------------------


def cli_args(fasta: str, outdir: str, *extra: str, k: int = K, m: int = M):
    """One-device CLI arguments at the smoke run's [LOWER, UPPER]."""
    return [fasta, outdir, "-k", str(k), "-m", str(m), "-l", str(LOWER),
            "-u", str(UPPER), "--single-device", *extra]


def run_cli(args: list[str], clock: CompileClock) -> tuple[str, float, float]:
    """hysortk_tpu.cli.main in this process; returns (stdout, wall s,
    compile s)."""
    from hysortk_tpu import cli

    out = io.StringIO()
    c0 = clock.seconds
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(args)
    wall = time.perf_counter() - t0
    if rc != 0:
        sys.stdout.write(out.getvalue())
        fail(f"cli {' '.join(args)} returned {rc}")
    return out.getvalue(), wall, clock.seconds - c0


def check_cli_output(text: str, outdir: str, k: int, ref, label: str):
    from hysortk_tpu import testing
    from hysortk_tpu.io import writer

    keys, counts = testing.read_output_file(os.path.join(outdir, "0.out"), k)
    check(testing.same_counts(keys, counts, ref.keys, ref.counts),
          f"{label}: 0.out == reference ({keys.shape[0]} k-mers)")
    hist = writer.parse_histogram(text)
    want = {c: int(n) for c, n in enumerate(ref.hist) if c and n}
    check(hist == want, f"{label}: histogram == reference")
    return keys, counts


def span_seconds(text: str, name: str) -> float:
    m = re.search(rf"^\s+{name}: ([0-9.]+)s", text, re.M)
    if m is None:
        fail(f"no {name} span in the CLI report")
    return float(m.group(1))


def peak_bytes(dev) -> int:
    return dev.memory_stats()["peak_bytes_in_use"]


def report_run(text: str, wall: float, compile_s: float, ref, dev):
    spans = ", ".join(
        f"{name} {span_seconds(text, name):.3f} s"
        for name in ("read_fasta", "kmer_count", "write_output")
    )
    say(f"  wall {wall:.3f} s ({spans}), set-up (compile) {compile_s:.3f} s, "
        f"{ref.n_distinct} distinct k-mers, {ref.keys.shape[0]} filtered, "
        f"peak_bytes_in_use {peak_bytes(dev)}")


def phase2_oneshot(data: ReadSet, ref, clock, dev):
    import jax

    from hysortk_tpu import pipeline
    from hysortk_tpu.config import KmerConfig

    say("== phase 2: CLI one shot, K=31, one device")
    outdir = os.path.join(data.workdir, "out_oneshot")
    text, wall, comp = run_cli(cli_args(data.fasta, outdir), clock)
    result = check_cli_output(text, outdir, K, ref, "one shot")
    report_run(text, wall, comp, ref, dev)
    # The main step, compiled again for its memory analysis (a persistent
    # cache hit after the run above).
    cfg = KmerConfig(k=K, m=M, lower=LOWER, upper=UPPER)
    n = pipeline.flat_size(data.sim.reads.size, cfg.pad_multiple)
    compiled = pipeline._count_device_packed.lower(
        jax.ShapeDtypeStruct((n // 16,), "uint32"),
        jax.ShapeDtypeStruct((data.sim.reads.shape[0],), "int32"),
        K, n, LOWER, UPPER,
    ).compile()
    say(f"  main step ({n} flat elements) memory_analysis: "
        f"{compiled.memory_analysis()}")
    return result


def phase3_streaming(data: ReadSet, ref, oneshot, clock, dev):
    from hysortk_tpu import testing

    say(f"== phase 3: CLI streaming, {STREAM_BATCH}-base batches")
    outdir = os.path.join(data.workdir, "out_stream")
    text, wall, comp = run_cli(
        cli_args(data.fasta, outdir, "--stream-batch-bases", str(STREAM_BATCH)),
        clock,
    )
    keys, counts = check_cli_output(text, outdir, K, ref, "streaming")
    check(testing.same_counts(keys, counts, *oneshot),
          "streaming == one shot")
    report_run(text, wall, comp, ref, dev)


def phase4_multik(data: ReadSet, clock, dev):
    say("== phase 4: CLI multi-K on a 16 Mb prefix")
    sim = data.sim.prefix(16_000_000)
    fasta = data.write("prefix16", sim)
    for k, m in ((15, 11), (55, 17)):
        ref = data.reference(sim, k)
        outdir = os.path.join(data.workdir, f"out_k{k}")
        text, wall, comp = run_cli(cli_args(fasta, outdir, k=k, m=m), clock)
        check_cli_output(text, outdir, k, ref, f"K={k}")
        report_run(text, wall, comp, ref, dev)


def phase5_ext(data: ReadSet, clock):
    import numpy as np

    import hysortk_tpu as H
    from hysortk_tpu import testing

    say("== phase 5: EXT, K=31 on a 4 Mb prefix")
    sim = data.sim.prefix(4_000_000)
    fasta = data.write("prefix4", sim)
    t0 = time.perf_counter()
    reads = [r.tobytes().decode() for r in sim.reads]
    occ = testing.oracle_occurrences(reads, K)
    want = {
        km.encode(): (len(s), s)
        for km, s in occ.items()
        if LOWER <= len(s) <= UPPER
    }
    say(f"  brute-force oracle: {len(occ)} distinct, {len(want)} filtered "
        f"({time.perf_counter() - t0:.1f} s)")
    outdir = os.path.join(data.workdir, "out_ext")
    text, wall, comp = run_cli(cli_args(fasta, outdir, "--extension"), clock)
    keys, counts = testing.read_output_file(os.path.join(outdir, "0.out"), K)
    want_keys = testing.pack_ascii_kmers(
        np.frombuffer(b"".join(want), dtype=np.uint8).reshape(-1, K)
    )
    want_counts = np.asarray([c for c, _ in want.values()])
    check(testing.same_counts(keys, counts, want_keys, want_counts),
          f"EXT CLI: 0.out == oracle counts ({keys.shape[0]} k-mers)")
    say(f"  wall {wall:.3f} s, set-up (compile) {comp:.3f} s")
    codes, lengths = H.read_dna_buffer(fasta)
    cfg = H.KmerConfig(k=K, m=M, lower=LOWER, upper=UPPER, extension=True)
    got, _ = H.kmer_count(codes, lengths, cfg, single_device=True)
    check(got.as_dict() == want,
          "EXT kmer_count: (read id, position) payloads == oracle")


# --- phase 6: per-stage timings ---------------------------------------------


def timed(fn, *args, reps: int = 5):
    """(best seconds, output) of fn(*args) after one warm-up call."""
    import jax

    out = jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best, out


def say_stage(name: str, secs: float, nbytes: int, note: str = "") -> None:
    say(f"  {name}: {secs * 1e3:.3f} ms, {nbytes} B moved, "
        f"{nbytes / secs / 1e9:.1f} GB/s{note}")


def sort_lowering(fn, *args) -> str:
    """Which sort implementation XLA chose, from the optimized HLO."""
    hlo = fn.lower(*args).compile().as_text()
    custom = sorted(set(re.findall(r'custom_call_target="([^"]+)"', hlo)))
    sorts = len(re.findall(r"\bsort\(", hlo))
    return f"custom calls {custom or 'none'}, {sorts} HLO sort op(s)"


def phase6_stages(data: ReadSet):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from hysortk_tpu.ops import count as count_ops
    from hysortk_tpu.ops import kmer as kmer_ops
    from hysortk_tpu.ops import sort as sort_ops

    n, w = STAGE_N, 2
    say(f"== phase 6: plain XLA stages at {n} elements, K={K} (W={w})")
    reads = data.sim.reads
    r = min((n - 16) // reads.shape[1], reads.shape[0])
    codes = np.zeros(n, np.int8)
    codes[: r * reads.shape[1]] = data.sim.codes()[: r * reads.shape[1]]
    pos = np.arange(n) % reads.shape[1]
    valid = (np.arange(n) < r * reads.shape[1]) & (pos <= reads.shape[1] - K)
    codes_j, valid_j = jnp.asarray(codes), jnp.asarray(valid)

    @jax.jit
    def keybuild(c, v):
        words = kmer_ops.canonical_words(c.astype(jnp.int32), K)
        return tuple(sort_ops.apply_sentinel(~v, words))

    @jax.jit
    def sort(ws):
        return jax.lax.sort(ws, num_keys=len(ws), is_stable=False)

    @jax.jit
    def count_filter(ws):
        head, cnt = count_ops.run_length_count(sort_ops.sentinel_valid(ws), ws)
        return cnt, count_ops.frequency_filter(head, cnt, LOWER, UPPER)

    @jax.jit
    def weighted_sum(ws, weights):
        return count_ops.run_length_sum(sort_ops.sentinel_valid(ws), ws, weights)

    t, marked = timed(keybuild, codes_j, valid_j)
    say_stage("key build", t, n * (2 + 4 * w))
    say(f"  sort lowering: {sort_lowering(sort, marked)}")
    t, sorted_w = timed(sort, marked)
    say_stage("lax.sort W=2 num_keys=2", t, 2 * n * 4 * w)
    t, (cnt, keep) = timed(count_filter, sorted_w)
    say_stage("count + filter", t, n * (4 * w + 5))
    weights = jnp.where(keep, cnt, 1).astype(jnp.int32)
    t, _ = timed(weighted_sum, sorted_w, weights)
    say_stage("weighted run-length sum", t, n * (4 * w + 9))

    @jax.jit
    def sort_runs(ws, tag):
        rows = [x.reshape(tag.shape[0], -1) for x in ws]
        out = jax.lax.sort((*rows, tag), dimension=1, num_keys=len(ws),
                           is_stable=False)
        return tuple(x.reshape(-1) for x in out)

    @jax.jit
    def merge(words, payloads):
        _, merged, pays = sort_ops.sort_marked(list(words), list(payloads))
        return tuple(merged), tuple(pays)

    # The run merge as the streaming consolidation (8 runs + count payload)
    # and the range exchange's receive side (4 runs, keys only) hold it.
    for runs, n_pay in ((8, 1), (4, 0)):
        tag = jnp.arange(n, dtype=jnp.uint32).reshape(runs, n // runs)
        sr = sort_runs(marked, tag)
        t, (merged, _) = timed(merge, sr[:w], sr[w:][:n_pay])
        check(all(bool((a == b).all()) for a, b in zip(merged, sorted_w)),
              f"merge of {runs} sorted runs == full sort")
        say_stage(f"run merge (lax.sort re-sort), {runs} runs of "
                  f"{n // runs}, W={w}" + (" + payload" if n_pay else ""),
                  t, 2 * n * 4 * (w + n_pay))


# --- --cards 4: the sharded path --------------------------------------------


def cards4(data: ReadSet, devices, clock):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from hysortk_tpu import pipeline, testing
    from hysortk_tpu.config import KmerConfig
    from hysortk_tpu.parallel import pipeline as shard_pipeline
    from hysortk_tpu.parallel.mesh import SHARD_AXIS, make_mesh

    mesh = make_mesh(devices[:4])
    ref = data.reference(data.sim, K)
    codes, lengths = data.sim.codes(), data.sim.lengths
    cfg = KmerConfig(k=K, m=M, lower=LOWER, upper=UPPER)

    probe = jax.device_put(
        jnp.arange(4 * 1024), NamedSharding(mesh, P(SHARD_AXIS))
    )
    check(len(probe.sharding.device_set) == 4,
          "a sharded array spans all four devices")

    for name, fn in (
        ("count_reads_sharded", lambda: shard_pipeline.count_reads_sharded(
            codes, lengths, cfg, mesh)),
        ("count_reads_sharded_streaming",
         lambda: shard_pipeline.count_reads_sharded_streaming(
             codes, lengths, cfg, 4 * STREAM_BATCH, mesh)),
    ):
        say(f"== {name}, 4 devices")
        c0 = clock.seconds
        t0 = time.perf_counter()
        got, hist = fn()
        cold = time.perf_counter() - t0
        comp = clock.seconds - c0
        t0 = time.perf_counter()
        got, hist = fn()
        warm = time.perf_counter() - t0
        check(testing.same_counts(got.keys, got.counts, ref.keys, ref.counts),
              f"{name} == reference ({len(got)} k-mers)")
        check(np.array_equal(np.asarray(hist)[: UPPER + 1], ref.hist),
              f"{name}: histogram == reference")
        say(f"  first call {cold:.3f} s (set-up/compile {comp:.3f} s), "
            f"second call {warm:.3f} s")

    peaks = [peak_bytes(d) for d in devices[:4]]
    say(f"  per-card peak_bytes_in_use: {peaks}")
    check(min(peaks) * 4 >= max(peaks), "work spread over all four cards")

    # The exchange step alone: one all_to_all of the range pipeline's
    # per-device send planes at about the one-shot shape.
    n_local = pipeline.flat_size(codes.size // 4, cfg.pad_multiple)
    cap = shard_pipeline.range_capacity(n_local, 4, cfg)

    @jax.jit
    def exchange(*planes):
        def body(*xs):
            return tuple(
                jax.lax.all_to_all(x, SHARD_AXIS, 0, 0, tiled=True) for x in xs
            )

        return jax.shard_map(
            body, mesh=mesh, in_specs=(P(SHARD_AXIS),) * len(planes),
            out_specs=(P(SHARD_AXIS),) * len(planes), check_vma=False,
        )(*planes)

    planes = tuple(
        jax.device_put(
            jnp.zeros((4 * 4, cap), jnp.uint32), NamedSharding(mesh, P(SHARD_AXIS))
        )
        for _ in range(cfg.words)
    )
    t, _ = timed(exchange, *planes)
    per_card = 4 * cap * 4 * cfg.words * 3 // 4
    say(f"  exchange step (all_to_all, {cfg.words} x (4, {cap}) uint32 per "
        f"card): {t * 1e3:.3f} ms, {per_card} B sent per card, "
        f"{per_card / t / 1e9:.1f} GB/s per card")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4: run only the sharded path on four GPUs")
    args = ap.parse_args(argv)

    devices = phase0_platform(args.cards)
    import jax

    clock = CompileClock()
    workdir = os.path.join(HERE, ".smoke")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        data = ReadSet(args.seed, workdir)
        if args.cards == 4:
            cards4(data, devices, clock)
            count = len(jax.devices())
        else:
            ref = data.reference(data.sim, K)
            oneshot = phase2_oneshot(data, ref, clock, devices[0])
            phase3_streaming(data, ref, oneshot, clock, devices[0])
            del ref, oneshot
            phase4_multik(data, clock, devices[0])
            phase5_ext(data, clock)
            phase6_stages(data)
            count = len(jax.devices())
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    dev = devices[0]
    say(json.dumps({
        "ok": True,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": count},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
