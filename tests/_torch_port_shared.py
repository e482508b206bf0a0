"""Fixture values computed once a test run, not once an xdist worker, and
the workers' freed memory handed back to the system.

Under `pytest -n N --dist load` every worker that draws a test of a file
builds that file's module fixtures again: the costly ones (JAX compiles,
float64 steps, spawned gloo ranks) then run in several workers at once,
which costs their time and the machine's memory. `shared` follows the
pattern pytest-xdist documents for session data: the workers of one run
share `tmp_path_factory.getbasetemp().parent`; the first worker to take a
file lock there computes the value and writes it with `torch.save`, and
the others wait on the lock and read the file. The worker that wrote it
deletes it, under the lock, when it ends; a worker that asks after that
computes it again. Without xdist the value is computed in the process.

Share the numbers the tests compare (tensors, dicts), not live models,
process groups or paths of files: what `compute` returns must survive
`torch.save`, and nothing else of it outlives `compute`.

A worker runs tests of many files one after another, and glibc keeps on
its heap what their tensors and compiles freed, so a worker's resident
memory only grows, and six workers together can outgrow the machine.
Importing this module in an xdist worker (every worker imports every test
file, so every worker of a run) starts one daemon thread that hands the
free heap back to the system (`malloc_trim(0)`) every TRIM_SECONDS.
"""

import ctypes
import fcntl
import os
import threading
import time

import torch

TRIM_SECONDS = 5.0


def _trim_forever(malloc_trim):
    while True:
        time.sleep(TRIM_SECONDS)
        malloc_trim(0)


def _start_trimming():
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return
    try:
        malloc_trim = ctypes.CDLL("libc.so.6").malloc_trim
    except (OSError, AttributeError):  # not glibc
        return
    malloc_trim.argtypes = [ctypes.c_size_t]
    threading.Thread(target=_trim_forever, args=(malloc_trim,), name="malloc_trim",
                     daemon=True).start()


_start_trimming()


def shared(request, name, compute):
    """compute(), run by one worker of the run under a lock; the others
    read its saved result. A failed compute leaves no file, so the next
    worker that asks computes again and meets the same error. `request`
    is the fixture's request."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return compute()
    root = request.getfixturevalue("tmp_path_factory").getbasetemp().parent
    path = root / f"shared_{name}.pt"
    lock_path = root / f"shared_{name}.lock"
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if path.exists():
                return torch.load(path, weights_only=False)
            value = compute()
            tmp = path.with_suffix(".tmp")
            torch.save(value, tmp)
            os.replace(tmp, path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)

    def remove():
        with open(lock_path, "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            path.unlink(missing_ok=True)

    request.config.add_cleanup(remove)
    return value
