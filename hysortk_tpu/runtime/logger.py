"""Rank-aware logging.

Analogue of the reference's Logger (include/logger.hpp:12-30,
src/logger.cpp:109-160), which buffers per-rank messages and gathers them to
root over MPI. In the JAX world a "rank" is a host process
(jax.process_index()); gathering uses multihost_utils when a multi-host
runtime is initialized, and degrades to plain stdout on one host.
"""

from __future__ import annotations

import io
import sys


class Logger:
    """Buffered per-process logger with a gathered flush."""

    def __init__(self, stream=None):
        self._buf = io.StringIO()
        self._stream = stream or sys.stdout

    @property
    def process_index(self) -> int:
        try:
            import jax

            return jax.process_index()
        except Exception:
            return 0

    def log(self, msg: str) -> None:
        """Buffer a message for the next flush (reference Logger::operator())."""
        self._buf.write(msg)
        self._buf.write("\n")

    def root(self, msg: str) -> None:
        """Print immediately from process 0 only (reference flush_root)."""
        if self.process_index == 0:
            print(msg, file=self._stream)

    def flush(self, label: str = "") -> None:
        """Gather all processes' buffers and print them labeled per process
        (reference Logger::flush, src/logger.cpp:109-160)."""
        mine = self._buf.getvalue()
        self._buf = io.StringIO()
        try:
            import jax

            nproc = jax.process_count()
        except Exception:
            nproc = 1
        if nproc == 1:
            if label:
                print(f"## {label}", file=self._stream)
            if mine:
                print(f"[proc 0] {mine}", end="", file=self._stream)
            return
        from jax.experimental import multihost_utils

        import numpy as np

        data = mine.encode()
        maxlen = int(
            multihost_utils.process_allgather(np.array(len(data))).max()
        )
        padded = np.zeros(maxlen, dtype=np.uint8)
        padded[: len(data)] = np.frombuffer(data, dtype=np.uint8)
        gathered = multihost_utils.process_allgather(padded)
        lengths = multihost_utils.process_allgather(np.array(len(data)))
        if self.process_index == 0:
            if label:
                print(f"## {label}", file=self._stream)
            for p in range(nproc):
                text = bytes(gathered[p][: int(lengths[p])]).decode()
                for line in text.splitlines():
                    print(f"[proc {p}] {line}", file=self._stream)
