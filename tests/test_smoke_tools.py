"""chip_smoke.py's read simulator, the compile-cache rule, and the refusal
of the device scripts to report anything without a GPU."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import hysortk_tpu as H
from hysortk_tpu import testing
from hysortk_tpu.runtime import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(genome_len=30_000, n_families=4, unit_len=(500, 1500))


def test_simulated_reads_are_deterministic():
    a = testing.simulate_reads(7, **SMALL)
    b = testing.simulate_reads(7, **SMALL)
    c = testing.simulate_reads(8, **SMALL)
    assert np.array_equal(a.reads, b.reads)
    assert (a.n_errors, a.n_n_bases) == (b.n_errors, b.n_n_bases)
    assert not np.array_equal(a.reads, c.reads)


@pytest.mark.parametrize("coverage", [5.0, 30.0, 60.0])
def test_simulated_reads_coverage(coverage):
    sim = testing.simulate_reads(1, coverage=coverage, **SMALL)
    assert sim.reads.shape == (int(coverage * 30_000 / 150), 150)
    assert set(np.unique(sim.reads).tobytes()) <= set(b"ACGTN")
    assert sim.n_n_bases == int((sim.reads == ord("N")).sum()) > 0


@pytest.mark.parametrize("rate", [0.001, 0.005, 0.02])
def test_simulated_reads_error_rate(rate):
    sim = testing.simulate_reads(2, error_rate=rate, **SMALL)
    assert abs(sim.n_errors / sim.reads.size - rate) < 0.2 * rate
    # Error-free k-mers recur ~coverage times; errors add singletons.
    clean = testing.simulate_reads(2, error_rate=0.0, **SMALL)
    k = 31
    noisy = testing.reference_count(sim.codes(), sim.lengths, k, 1, 10**6)
    base = testing.reference_count(clean.codes(), clean.lengths, k, 1, 10**6)
    assert noisy.n_distinct > base.n_distinct
    # Repeat families make heavy hitters well above the coverage.
    assert base.counts.max() > 2 * 30


def test_simulated_reads_prefix_and_fasta(tmp_path):
    sim = testing.simulate_reads(3, **SMALL)
    pre = sim.prefix(20_000)
    assert pre.reads.shape == (133, 150)
    path = str(tmp_path / "p.fa")
    testing.write_fasta(path, pre.reads)
    with open(path) as f:
        assert max(len(line) for line in f) == 61  # 60 columns + newline
    codes, lengths = H.read_dna_buffer(path)
    assert np.array_equal(lengths, pre.lengths)
    assert np.array_equal(codes, pre.codes())


def test_compile_cache_env_set(monkeypatch, tmp_path):
    import jax

    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    assert compile_cache.setup_compile_cache() == str(tmp_path)
    assert calls == []


def test_compile_cache_env_unset(monkeypatch):
    import jax

    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    path = compile_cache.setup_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]


def _run_without_gpu(script: str, cwd: str):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    env.pop("XLA_FLAGS", None)
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=240,
    )


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_device_scripts_refuse_without_gpu(script):
    proc = _run_without_gpu(script, REPO)
    assert proc.returncode != 0
    assert "no GPU" in proc.stderr
    for line in proc.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run_without_gpu("chip_smoke.py", str(tmp_path))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
