"""Host pipelining around the device step.

The counterpart of ``sdrpp_tpu.utils.pipeline`` (the reference pipelines by
running every dsp::block in its own thread, with SampleFrameBuffer
between source and graph, core/src/dsp/buffer/frame_buffer.h:10-133):

- :class:`Prefetcher`: a reader thread keeps ``DEPTH`` blocks of the
  source ahead of the consumer, so source IO overlaps device compute. On
  a CUDA device each block is staged in one of a small ring of pinned
  host buffers and copied ``non_blocking`` on a side stream, which the
  compute stream waits on; the block tensor is recorded on the compute
  stream, and a slot is refilled only after its copy's event.
- :class:`DeferredWriter`: holds each block's output one iteration before
  handing it to ``write_fn`` on the host. On a CUDA device the output is
  copied ``non_blocking`` into pinned memory at ``push`` and its event is
  synchronised only when the next block has been enqueued.

Together, read | device | write run as a 3-stage pipeline with the same
(state, x) -> (state, y) step and the same outputs, byte for byte.

Spans (``utils.tracing.annotate``; each carries the block's number, the
Prefetcher's reads and the DeferredWriter's pushes counted from 0, which
in a streaming loop of objects built for it are the step's calls):
``prefetch.wait`` (the queue, with the blocks ready as its value),
``prefetch.stage`` (the pinned slot freed and filled), ``prefetch.h2d``
(the copy enqueued on the side stream); ``writer.d2h`` (the pinned
buffer and the copy on the compute stream, timed on the card too) and
``writer.wait`` (a block's copy waited for and handed to ``write_fn``).
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from .tracing import annotate

__all__ = ["DEPTH", "Prefetcher", "DeferredWriter"]

DEPTH = 2  # blocks the reader runs ahead; the pinned ring holds DEPTH + 1


class Prefetcher:
    """``read(n)`` returns the source's next fixed-size block as a
    complex64 tensor on ``device``, fed by a background reader thread.

    Keeps the wrapped source's block sequence exactly (same ``block``
    every call). A short read (a file's end) ends the stream: after it,
    and once the reader has stopped, ``read`` returns zeros. A reader
    error is sticky: every later ``read`` raises it.
    """

    def __init__(self, source, block: int, device="cuda"):
        self.source = source
        self.samplerate = source.samplerate
        self.block = int(block)
        self.device = torch.device(device)
        self._q: queue.Queue = queue.Queue(maxsize=DEPTH)
        self._stop = threading.Event()
        self._exc: Exception | None = None
        self._eof = False
        if self.device.type == "cuda":
            slots = DEPTH + 1
            self._slots = [torch.empty(self.block, dtype=torch.complex64,
                                       pin_memory=True) for _ in range(slots)]
            self._copied = [torch.cuda.Event() for _ in range(slots)]
            self._side = torch.cuda.Stream(self.device)
            self._next = 0
        self._reads = 0
        self._thread = threading.Thread(target=self._fill, daemon=True,
                                        name="prefetcher")
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _fill(self):
        try:
            while not self._stop.is_set():
                chunk = self.source.read(self.block)
                if not self._put(chunk):
                    return
                if len(chunk) < self.block:
                    self._eof = True
                    return
        except Exception as e:  # the reader's boundary: handed to read()
            self._exc = e

    def _chunk(self) -> np.ndarray:
        while True:
            try:
                return self._q.get(timeout=0.2)
            except queue.Empty:
                if self._exc is not None:
                    raise self._exc
                if self._eof or not self._thread.is_alive():
                    # like FileSource(loop=False) past its end: silence
                    return np.zeros(self.block, np.complex64)

    def read(self, n: int) -> torch.Tensor:
        if n != self.block:
            raise ValueError(f"Prefetcher reads blocks of {self.block}, "
                             f"not {n}")
        block, self._reads = self._reads, self._reads + 1
        with annotate("prefetch.wait", block, value=self._q.qsize()):
            chunk = np.ascontiguousarray(self._chunk(), np.complex64)
        if self.device.type != "cuda":
            return torch.from_numpy(chunk).to(self.device)
        k = self._next
        self._next = (k + 1) % len(self._slots)
        with annotate("prefetch.stage", block):
            self._copied[k].synchronize()  # the slot's last copy is done
            slot = self._slots[k][:len(chunk)]  # short at a file's end
            slot.numpy()[:] = chunk
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._side), annotate("prefetch.h2d", block):
            x = torch.empty(len(chunk), dtype=torch.complex64,
                            device=self.device)
            x.copy_(slot, non_blocking=True)
            self._copied[k].record(self._side)
        compute.wait_event(self._copied[k])
        # x was made on the side stream: keep its memory from reuse until
        # the compute stream's work on it is done
        x.record_stream(compute)
        return x

    def close(self):
        self._stop.set()
        try:  # unblock a full queue
            self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
        if hasattr(self.source, "close"):
            self.source.close()


class DeferredWriter:
    """Depth-1 output pipeline: ``push(out)`` holds the block's output (a
    tensor) one call before handing it to ``write_fn`` as a numpy array,
    so the device computes the next block while the host writes this one.
    ``flush()`` hands over the last block."""

    def __init__(self, write_fn):
        self.write_fn = write_fn
        self._pending = None
        self._pushes = 0

    def push(self, out):
        block, self._pushes = self._pushes, self._pushes + 1
        with annotate("writer.d2h", block, device=True):
            out = torch.as_tensor(out)
            if out.is_cuda:
                host = torch.empty(out.shape, dtype=out.dtype,
                                   pin_memory=True)
                host.copy_(out, non_blocking=True)
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(out.device))
                item = (host, done, block)
            else:
                item = (out, None, block)
        prev, self._pending = self._pending, item
        if prev is not None:
            self._write(prev)

    def _write(self, item):
        host, done, block = item
        with annotate("writer.wait", block):
            if done is not None:
                done.synchronize()
            self.write_fn(host.numpy())

    def flush(self):
        if self._pending is not None:
            item, self._pending = self._pending, None
            self._write(item)
