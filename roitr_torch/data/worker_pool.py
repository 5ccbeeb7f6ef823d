"""Preprocessing worker pool: subprocesses speaking pickle frames on pipes.

Counterpart of roitr_tpu/data/worker_pool.py (the reference's DataLoader
workers, main.py:113-127, num_workers=8). Each worker is a plain
`python -S -m roitr_torch.data.worker_main` subprocess: a clean
interpreter that never sees the caller's __main__ (multiprocessing's spawn
and forkserver re-import it; fork copies a process whose threads may hold
locks, torch's and CUDA's among them) and imports only what unpickling
the dataset needs.

The protocol is length-prefixed pickle frames: the parent sends the
dataset once, then indices; each worker answers its indices in order
(FIFO). Indices go out round-robin and answers are read round-robin, so
the items come back in the order asked. Pipe buffers give backpressure.

Workers never touch the card: `CUDA_VISIBLE_DEVICES` is empty in their
environment and items stay numpy. Each runs one intra-op thread
(`OMP_NUM_THREADS=1`), so that N workers do not each spin every core. A
worker's exception comes back with its traceback and is raised in the
parent, as is the death of a worker; nothing is prepared in process in
their place.
"""

from __future__ import annotations

import os
import pickle
import struct
import subprocess
import sys
from typing import Iterator, Sequence

_HDR = struct.Struct("<Q")
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# items a worker holds queued ahead of the reads
_DEPTH = 4


def write_frame(fd: int, obj) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    view = memoryview(_HDR.pack(len(payload)) + payload)
    while view:  # os.write to a pipe may be partial
        view = view[os.write(fd, view):]


def _read_exact(fd: int, n: int):
    """n bytes from fd; None on a clean end of file at a frame boundary."""
    chunks, got = [], 0
    while got < n:
        chunk = os.read(fd, n - got)
        if not chunk:
            if not chunks:
                return None
            raise EOFError("pipe closed mid-frame")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def read_frame(fd: int):
    """The next frame's object; None at a clean end of file."""
    hdr = _read_exact(fd, _HDR.size)
    if hdr is None:
        return None
    payload = _read_exact(fd, _HDR.unpack(hdr)[0])
    if payload is None:
        raise EOFError("pipe closed mid-frame")
    return pickle.loads(payload)


def worker_env() -> dict:
    """The workers' environment: no CUDA device, one thread, and this
    checkout's root before the parent's sys.path (with -S, site does not
    run, so PYTHONPATH must name site-packages and the directories the
    dataset's classes live in)."""
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["OMP_NUM_THREADS"] = "1"
    env["MKL_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = os.pathsep.join([_ROOT] + [p for p in sys.path if p])
    return env


class WorkerPool:
    """Ordered parallel map of dataset[i] over `num_workers` subprocesses."""

    def __init__(self, dataset, num_workers: int):
        if num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")
        cfg = getattr(dataset, "config", None)
        if getattr(cfg, "host_pyramid", False):
            # build the native library once here, not in every worker
            from roitr_torch import native

            native.build()
        self.num_workers = num_workers
        env = worker_env()
        # the parent's working directory, where a dataset's relative paths
        # point; PYTHONPATH finds the package
        self.procs = [subprocess.Popen([sys.executable, "-S", "-m", "roitr_torch.data.worker_main"],
                                       stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env)
                      for _ in range(num_workers)]
        blob = pickle.dumps(dataset, protocol=pickle.HIGHEST_PROTOCOL)
        for p in self.procs:
            write_frame(p.stdin.fileno(), blob)

    def imap(self, indices: Sequence[int]) -> Iterator:
        """Yield dataset[i] for i in indices, in order."""
        indices = [int(i) for i in indices]
        w = self.num_workers
        sent = min(len(indices), w * _DEPTH)
        for j in range(sent):
            write_frame(self.procs[j % w].stdin.fileno(), indices[j])
        for j in range(len(indices)):
            proc = self.procs[j % w]
            item = read_frame(proc.stdout.fileno())
            if item is None:
                try:
                    code = proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    code = None
                raise RuntimeError(f"preprocessing worker {j % w} died (exit {code}) before "
                                   f"answering index {indices[j]}; its stderr is above")
            if isinstance(item, dict) and item.get("__worker_error__"):
                raise RuntimeError(f"preprocessing worker {j % w} raised on index {indices[j]}:\n"
                                   f"{item['traceback']}")
            if sent < len(indices):
                write_frame(self.procs[sent % w].stdin.fileno(), indices[sent])
                sent += 1
            yield item

    def close(self) -> None:
        """End the workers: end of file on their input, then their output
        closed (a worker still writing ends on the broken pipe), killed if
        still alive after 5 s."""
        for p in self.procs:
            for f in (p.stdin, p.stdout):
                try:
                    f.close()
                except OSError:
                    pass
        for p in self.procs:
            try:
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        self.procs = []

    def __enter__(self) -> "WorkerPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        if getattr(self, "procs", None):
            self.close()
