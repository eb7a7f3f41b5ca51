"""CLI argument handling and end-to-end file outputs."""

import numpy as np
import pytest

from hysortk_tpu import cli
from hysortk_tpu.io import writer
from hysortk_tpu import testing as oracle


def test_help_exits_zero(capsys):
    with pytest.raises(SystemExit) as e:
        cli.build_parser().parse_args(["--help"])
    assert e.value.code == 0
    assert "minimizer" in capsys.readouterr().out


def test_missing_fasta_arg():
    with pytest.raises(SystemExit) as e:
        cli.build_parser().parse_args([])
    assert e.value.code != 0


def test_invalid_sort_choice():
    """The sort is plain lax.sort on every platform: no --sort flag."""
    for value in ("xla", "pallas", "auto", "bogus"):
        with pytest.raises(SystemExit):
            cli.build_parser().parse_args(["x.fa", "--sort", value])


@pytest.mark.parametrize("extension", [False, True])
def test_cli_single_device_on_multi_device_host(tmp_path, monkeypatch,
                                                extension):
    """--single-device runs on one device even where JAX sees several:
    the sharded entry points must not be reached."""
    import jax

    from hysortk_tpu.parallel import pipeline as shard_pipeline

    assert len(jax.devices()) > 1

    def refuse(*a, **k):
        raise AssertionError("sharded path reached under --single-device")

    for name in ("count_reads_sharded", "count_reads_sharded_ext",
                 "count_reads_sharded_streaming"):
        monkeypatch.setattr(shard_pipeline, name, refuse)
    rng = np.random.default_rng(4)
    reads = oracle.random_reads(rng, 12, 40, 80) * 2
    fasta = tmp_path / "s.fa"
    fasta.write_text("".join(f">r{i}\n{r}\n" for i, r in enumerate(reads)))
    outdir = tmp_path / "out"
    args = [str(fasta), str(outdir), "-k", "31", "-l", "2", "-u", "50",
            "--single-device", "--no-histogram"]
    assert cli.main(args + (["--extension"] if extension else [])) == 0
    want = {
        k.encode(): v
        for k, v in oracle.oracle_filtered(reads, 31, 2, 50).items()
    }
    assert writer.parse_output_files(str(outdir)) == want


def test_cli_end_to_end(tmp_path, capsys):
    rng = np.random.default_rng(8)
    reads = oracle.random_reads(rng, 25, 35, 90)
    reads = reads + reads[:10]
    fasta = tmp_path / "c.fa"
    with open(fasta, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n{r}\n")
    outdir = tmp_path / "out"
    rc = cli.main(
        [str(fasta), str(outdir), "-k", "31", "-m", "17", "-l", "2",
         "-u", "50", "--single-device"]
    )
    assert rc == 0
    got = writer.parse_output_files(str(outdir))
    want = {
        k.encode(): v
        for k, v in oracle.oracle_filtered(reads, 31, 2, 50).items()
    }
    assert got == want
    out = capsys.readouterr().out
    assert "#count\tnumkmers" in out


def test_cli_bad_config_rejected(tmp_path):
    fasta = tmp_path / "x.fa"
    fasta.write_text(">r0\nACGT\n")
    with pytest.raises(ValueError):
        cli.main([str(fasta), "-k", "200"])


def test_cli_supermer_routing_end_to_end(tmp_path, capsys):
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs the virtual CPU mesh")
    rng = np.random.default_rng(12)
    reads = oracle.random_reads(rng, 20, 35, 90)
    reads = reads + reads[:8]
    fasta = tmp_path / "s.fa"
    with open(fasta, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n{r}\n")
    outdir = tmp_path / "out"
    rc = cli.main(
        [str(fasta), str(outdir), "-k", "31", "-m", "17", "-l", "2",
         "-u", "50", "--routing", "supermer"]
    )
    assert rc == 0
    got = writer.parse_output_files(str(outdir))
    want = {k.encode(): v
            for k, v in oracle.oracle_filtered(reads, 31, 2, 50).items()}
    assert got == want


def test_cli_device_compact_streaming(tmp_path):
    rng = np.random.default_rng(13)
    reads = oracle.random_reads(rng, 18, 40, 80) * 2
    fasta = tmp_path / "d.fa"
    with open(fasta, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n{r}\n")
    outdir = tmp_path / "out"
    rc = cli.main(
        [str(fasta), str(outdir), "-k", "31", "-m", "17", "-l", "1",
         "-u", "500", "--single-device", "--device-compact",
         "--stream-batch-bases", "600"]
    )
    assert rc == 0
    got = writer.parse_output_files(str(outdir))
    want = {k.encode(): v
            for k, v in oracle.oracle_filtered(reads, 31, 1, 500).items()}
    assert got == want


def test_cli_supermer_streaming_end_to_end(tmp_path):
    """supermer + --stream-batch-bases is a real path: bounded batches
    through the supermer dispatch."""
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs the virtual CPU mesh")
    rng = np.random.default_rng(14)
    reads = oracle.random_reads(rng, 24, 40, 90)
    reads = reads + reads[:10]
    fasta = tmp_path / "ss.fa"
    with open(fasta, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n{r}\n")
    outdir = tmp_path / "out"
    rc = cli.main(
        [str(fasta), str(outdir), "-k", "31", "-m", "17", "-l", "2",
         "-u", "50", "--routing", "supermer",
         "--stream-batch-bases", "900"]
    )
    assert rc == 0
    got = writer.parse_output_files(str(outdir))
    want = {k.encode(): v
            for k, v in oracle.oracle_filtered(reads, 31, 2, 50).items()}
    assert got == want


def test_cli_supermer_single_device_rejected():
    with pytest.raises(SystemExit):
        cli.main(["x.fa", "--routing", "supermer", "--single-device"])


def test_cli_validate_flag(tmp_path, capsys):
    """--validate recounts with the host oracle and reports OK."""
    rng = np.random.default_rng(15)
    reads = oracle.random_reads(rng, 16, 40, 80) * 2
    fasta = tmp_path / "v.fa"
    with open(fasta, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n{r}\n")
    rc = cli.main(
        [str(fasta), "-k", "31", "-m", "17", "-l", "1", "-u", "500",
         "--single-device", "--validate", "--no-histogram"]
    )
    assert rc == 0
    assert "validate OK" in capsys.readouterr().out
