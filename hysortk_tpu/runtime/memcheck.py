"""Host + device memory telemetry.

Analogue of the reference's memcheck (src/memcheck.cpp:7-106): VmRSS/VmHWM
from /proc/self/status and MemFree from /proc/meminfo, plus the addition the
reference has no equivalent for — per-device memory stats from jax's
memory_stats(). The reference uses MemFree to pick its sorter
(src/kmerops.cpp:1344-1379); we use device headroom to size device batches.
"""

from __future__ import annotations

from typing import Optional


def _proc_status_kb(field: str) -> Optional[int]:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith(field + ":"):
                    return int(line.split()[1])
    except OSError:
        return None
    return None


def get_rss_gb() -> float:
    """Current resident set size in GiB (reference VmRSS probe)."""
    kb = _proc_status_kb("VmRSS")
    return (kb or 0) / (1024 * 1024)


def get_peak_rss_gb() -> float:
    """Peak RSS in GiB (reference VmHWM probe)."""
    kb = _proc_status_kb("VmHWM")
    return (kb or 0) / (1024 * 1024)


def get_free_memory_kb() -> int:
    """Host MemFree in kB (reference get_free_memory_kb)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemFree:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return 0


def get_hbm_stats(device=None) -> Optional[dict]:
    """{'bytes_in_use', 'bytes_limit'} for a device, if the backend reports it."""
    import jax

    # local_devices, not devices: under jax.distributed, devices()[0] is
    # process 0's device, and memory_stats on a NON-addressable device
    # raises (measured: killed the 2-process streaming harness when the
    # depth rule first probed headroom on process 1).
    dev = device or jax.local_devices()[0]
    try:
        stats = getattr(dev, "memory_stats", lambda: None)()
    except Exception:
        return None
    if not stats:
        return None
    return {
        "bytes_in_use": stats.get("bytes_in_use", 0),
        "bytes_limit": stats.get("bytes_limit", 0),
    }


def hbm_headroom_bytes(device=None, safety: float = 0.9) -> Optional[int]:
    """Usable device-memory headroom; the analogue of the reference's
    sort_decision input (90% of MemFree, src/kmerops.cpp:1358-1376).

    None on CPU devices, which report no memory stats. An accelerator
    without memory stats is an error: every batch-sizing rule depends on
    this number, and no default fits every card.
    """
    import jax

    dev = device or jax.local_devices()[0]
    stats = get_hbm_stats(dev)
    if not stats or not stats["bytes_limit"]:
        if dev.platform == "cpu":
            return None
        raise RuntimeError(
            f"device {dev} ({dev.device_kind}) reports no memory stats"
        )
    return int(stats["bytes_limit"] * safety) - stats["bytes_in_use"]


def gathered_memory_report() -> str:
    """Cluster-wide memory report: every process's RSS/peak/MemFree gathered
    and formatted on all hosts — the reference's get_mem_gb Gather + root
    print (src/memcheck.cpp:60-106)."""
    import numpy as np

    local = np.asarray(
        [get_rss_gb(), get_peak_rss_gb(), get_free_memory_kb() / 1024 / 1024],
        dtype=np.float64,
    )
    import jax

    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        rows = np.asarray(multihost_utils.process_allgather(local))
    else:
        rows = local[None, :]
    lines = [
        f"  proc {i}: rss {r[0]:.2f} GB, peak {r[1]:.2f} GB, "
        f"free {r[2]:.2f} GB"
        for i, r in enumerate(rows)
    ]
    total = rows[:, 0].sum()
    lines.append(f"  total rss {total:.2f} GB across {rows.shape[0]} procs")
    return "-- memory --\n" + "\n".join(lines)
