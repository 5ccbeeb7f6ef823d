"""A dataset for the worker pool's tests (tests/test_torch_workers.py),
in a module of its own that imports neither torch nor JAX, so that a
worker unpickling it starts in about a second.

Item i is {"index": i} and what the worker process sees: its pid, its
CUDA_VISIBLE_DEVICES and OMP_NUM_THREADS, and, when the wrapped dataset
(`inner`) imported torch, torch's intra-op threads and whether CUDA is
available; with `inner`, its item i besides. `raise_at` raises on that
index, `exit_at` ends the worker (os._exit(3)) on it.
"""

import os
import sys


class WorkerProbe:
    def __init__(self, n: int, inner=None, raise_at: int = -1, exit_at: int = -1):
        self.n, self.inner, self.raise_at, self.exit_at = n, inner, raise_at, exit_at

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.exit_at:
            os._exit(3)
        if i == self.raise_at:
            raise ValueError(f"probe raised on index {i}")
        item = dict(self.inner[i]) if self.inner is not None else {}
        torch = sys.modules.get("torch")
        item.update(index=i, pid=os.getpid(), cuda_visible=os.environ.get("CUDA_VISIBLE_DEVICES"),
                    omp=os.environ.get("OMP_NUM_THREADS"),
                    threads=torch.get_num_threads() if torch else None,
                    cuda=torch.cuda.is_available() if torch else None)
        return item
