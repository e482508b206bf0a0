"""Experiment logging, the port's own copy of `mde_tpu/utils/logging.py`:
a JSONL event stream always, mirrored to TensorBoard where that package
exists.

The reference logs scalars every 5 steps and figure grids every 500 via
torch SummaryWriter (reference train.py:327, 432-452). Each JSONL line is
{"t": wall time, "tag": ..., "value": ..., "step": ...}.
"""

import json
import os
import time


class SummaryLogger:
    def __init__(self, log_dir: str, flush_secs: int = 1):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._jsonl = open(os.path.join(log_dir, "events.jsonl"), "a", buffering=1)
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        self._tb = SummaryWriter(log_dir, flush_secs=flush_secs)

    def add_scalar(self, tag: str, value, step: int):
        self._jsonl.write(json.dumps(
            {"t": time.time(), "tag": tag, "value": float(value), "step": int(step)}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
