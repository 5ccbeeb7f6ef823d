"""Entry module of the preprocessing worker subprocesses (worker_pool.py).

Frames on stdin / stdout (length-prefixed pickle):
  parent -> worker: the pickled dataset, then int indices until end of file
  worker -> parent: dataset[i] for each index, in order; an exception as
                    {"__worker_error__": True, "traceback": ...}

The real stdout is kept for the frames and fd 1 is pointed at stderr, so
that a print in dataset code cannot corrupt the stream. Run as
`python -S -m roitr_torch.data.worker_main`; importing it does nothing.
"""

import os
import pickle
import sys
import traceback


def main() -> None:
    from roitr_torch.data.worker_pool import read_frame, write_frame

    in_fd = sys.stdin.fileno()
    out_fd = os.dup(sys.stdout.fileno())
    os.dup2(sys.stderr.fileno(), sys.stdout.fileno())

    blob = read_frame(in_fd)
    if blob is None:
        return
    dataset = pickle.loads(blob)
    if "torch" in sys.modules:  # the datasets read .pth files with torch
        sys.modules["torch"].set_num_threads(1)
    while True:
        idx = read_frame(in_fd)
        if idx is None:
            return
        try:
            item = dataset[int(idx)]
        except Exception:
            item = {"__worker_error__": True, "traceback": traceback.format_exc()}
        try:
            write_frame(out_fd, item)
        except BrokenPipeError:  # the parent stopped reading: the pool closed
            return


if __name__ == "__main__":
    main()
