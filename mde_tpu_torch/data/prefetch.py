"""Host-to-device prefetch, the port's counterpart of
`mde_tpu/data/prefetch.py` (`DevicePrefetcher`).

A producer thread iterates the loader, copies each batch's arrays into
pinned host tensors and enqueues their copies to the device with
`non_blocking=True` on a side CUDA stream, where the NHWC arrays also become
NCHW tensors; an event recorded after them travels with the batch. The
consumer makes its current stream wait on that event before it hands the
batch out, so the copies of batch N+1 overlap the step on batch N. Up to
`depth` batches (2) are in flight. On the CPU the arrays become NCHW tensors
on the producer thread, with no stream.

Arrays under ARRAY_KEYS move; every other field (focal, has_valid_depth,
paths) passes through as the loader gave it. A loader error is raised in the
consumer.
"""

import queue
import threading

import numpy as np
import torch

ARRAY_KEYS = ("image", "depth", "semantics", "instance_labels", "instance_areas")


class DevicePrefetcher:
    """Iterate `loader` on `device`, keeping `depth` batches ahead."""

    def __init__(self, loader, device, depth: int = 2):
        self.loader = loader
        self.device = torch.device(device)
        self.depth = depth

    def __len__(self):
        return len(self.loader)

    def _put(self, batch, stream):
        out = dict(batch)
        keys = [k for k in ARRAY_KEYS if isinstance(out.get(k), np.ndarray)]
        if stream is None:
            for k in keys:
                out[k] = torch.from_numpy(out[k]).permute(0, 3, 1, 2).contiguous()
            return out, None
        with torch.cuda.stream(stream):
            for k in keys:
                host = torch.from_numpy(out[k]).pin_memory()
                out[k] = host.to(self.device, non_blocking=True).permute(0, 3, 1, 2).contiguous()
            event = torch.cuda.Event()
            event.record(stream)
        return out, event

    def __iter__(self):
        stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        q = queue.Queue(maxsize=self.depth)
        done = object()
        stop = threading.Event()
        errors = []

        def producer():
            try:
                for batch in self.loader:
                    item = self._put(batch, stream)
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except Exception as e:  # raised again in the consumer
                errors.append(e)
            finally:
                q.put(done)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    if errors:
                        raise errors[0]
                    return
                batch, event = item
                if event is not None:
                    current = torch.cuda.current_stream(self.device)
                    current.wait_event(event)
                    for k in ARRAY_KEYS:
                        if isinstance(batch.get(k), torch.Tensor):
                            batch[k].record_stream(current)
                yield batch
        finally:
            # a consumer that stops early (max_steps) ends the producer
            stop.set()
            while thread.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            thread.join()
