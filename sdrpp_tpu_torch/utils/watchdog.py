"""Failure detection / elastic recovery for streaming loops.

The counterpart of ``sdrpp_tpu.utils.watchdog``. ``StepWatchdog`` wraps a
step callable ``(state, x) -> (state, y)``:

- a per-call deadline (``timeout_s``): a SIGALRM around the call (main
  thread only), as in the JAX package, which on the CPU times the step
  itself. A step on the card returns once its kernels are queued, and a
  blocked ``torch.cuda.synchronize()`` cannot be interrupted by a signal,
  so when the step's output lies on a CUDA device the watchdog also
  records a CUDA event after the call and polls ``event.query()`` until
  the same deadline: it times the step's device work, not its enqueue,
  and raises ``StepTimeout`` when the work is not done in time;
- on failure: retries with a linear backoff. After ``rejit_after``
  consecutive failures the JAX package re-traces the step; a CUDA step
  has no executable to re-trace, but a device-side fault (an illegal
  address, a device-side assert) poisons the CUDA context for the rest
  of the process. So the watchdog probes the device
  (``device_poisoned``: a tiny launch and a synchronize): a poisoned
  context raises at once, since no retry can succeed; otherwise it calls
  ``make_step()`` again, as the JAX package does;
- optional periodic checkpointing through ``utils.checkpoint``, and the
  last good (state, offset) for a restore.
"""

from __future__ import annotations

import contextlib
import signal
import time

import torch

__all__ = ["StepTimeout", "StepWatchdog", "device_poisoned"]


class StepTimeout(Exception):
    """A single step exceeded the watchdog deadline."""


def device_poisoned(device) -> bool:
    """True when ``device`` can no longer run anything: on CUDA a
    device-side fault poisons the context until the process exits, and a
    tiny launch followed by a synchronize raises. Any other device:
    never. (The live receiver's recovery ladder asks the same question,
    misc/webui.py.)"""
    device = torch.device(device)
    if device.type != "cuda":
        return False
    try:
        torch.ones(1, device=device).add_(1.0)
        torch.cuda.synchronize(device)
    except Exception:
        return True
    return False


@contextlib.contextmanager
def _deadline(seconds: float):
    if not seconds or seconds <= 0:
        yield
        return

    def handler(signum, frame):
        raise StepTimeout()

    old = signal.signal(signal.SIGALRM, handler)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0.0)
        signal.signal(signal.SIGALRM, old)


def _cuda_device(tree):
    """The device of the first CUDA tensor in a dict/tuple/list tree, or
    None."""
    if isinstance(tree, torch.Tensor):
        return tree.device if tree.is_cuda else None
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        for v in tree:
            d = _cuda_device(v)
            if d is not None:
                return d
    return None


def _wait_device(device, deadline: float, poll_s: float = 1e-4):
    """Poll a CUDA event recorded now on ``device``'s current stream until
    it completes; StepTimeout once ``deadline`` (perf_counter) passes."""
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    while not ev.query():
        if time.perf_counter() >= deadline:
            raise StepTimeout()
        time.sleep(poll_s)


class StepWatchdog:
    """Supervised execution of a streaming step function.

    ``make_step()`` must return a fresh step callable (e.g. ``lambda:
    chan``); the watchdog calls it again after repeated failures.
    """

    def __init__(self, make_step, timeout_s: float = 0.0, max_retries: int = 3,
                 rejit_after: int = 2, backoff_s: float = 1.0,
                 checkpoint_path=None, checkpoint_every: int = 0,
                 on_event=None):
        self._make_step = make_step
        self._step = make_step()
        self.timeout_s = float(timeout_s)
        self.max_retries = int(max_retries)
        self.rejit_after = int(rejit_after)
        self.backoff_s = float(backoff_s)
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = int(checkpoint_every)
        self.on_event = on_event or (lambda kind, **kw: None)
        self.consecutive_failures = 0
        self.total_failures = 0
        self.steps = 0
        self._last_good = None  # (state, offset)

    # -- checkpointing --------------------------------------------------
    def _maybe_checkpoint(self, state, offset: int):
        self._last_good = (state, offset)
        if (self.checkpoint_path and self.checkpoint_every
                and self.steps % self.checkpoint_every == 0):
            from .checkpoint import save_state

            save_state(self.checkpoint_path, state, stream_offset=offset)
            self.on_event("checkpoint", offset=offset)

    def restore(self, template_state):
        """(state, offset) from the newest source: in-memory last-good,
        else the checkpoint file, else (template_state, 0)."""
        if self._last_good is not None:
            return self._last_good
        if self.checkpoint_path:
            try:
                from .checkpoint import load_state

                return load_state(self.checkpoint_path, template_state)
            except Exception:
                pass
        return template_state, 0

    # -- the supervised call --------------------------------------------
    def __call__(self, state, x, offset: int = 0):
        # ``offset`` = stream position AFTER this step (the resume point)
        attempt = 0
        while True:
            try:
                t_end = time.perf_counter() + self.timeout_s
                with _deadline(self.timeout_s):
                    out = self._step(state, x)
                device = _cuda_device(out) if self.timeout_s > 0 else None
                if device is not None:
                    _wait_device(device, t_end)
                self.steps += 1
                self.consecutive_failures = 0
                new_state = out[0] if isinstance(out, tuple) else out
                self._maybe_checkpoint(new_state, offset)
                return out
            except Exception as e:
                self.consecutive_failures += 1
                self.total_failures += 1
                attempt += 1
                self.on_event("failure", error=e, attempt=attempt)
                if attempt > self.max_retries:
                    raise
                if attempt >= self.rejit_after:
                    device = _cuda_device((state, x))
                    if device is not None and device_poisoned(device):
                        # the context is lost: a retry cannot succeed
                        self.on_event("poisoned", attempt=attempt)
                        raise
                    self._step = self._make_step()
                    self.on_event("rejit", attempt=attempt)
                time.sleep(self.backoff_s * attempt)
