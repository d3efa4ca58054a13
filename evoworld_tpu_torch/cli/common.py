"""Shared CLI plumbing: config parsing, frame IO, logging (counterpart of
`evoworld_tpu/cli/common.py`; the log lines through `utils/logging.py`).

Overrides: --section.field=value (sections pipeline, loop, train, trainer,
data, runtime, parity). Entry points run on CUDA; a caller asks for the CPU
through `main(argv, device="cpu")`.
"""

from __future__ import annotations

import logging
import os
import queue
import sys
import threading
import time
import warnings
import weakref

import numpy as np
import torch

from evoworld_tpu_torch.config import EvoWorldConfig, apply_overrides, describe
from evoworld_tpu_torch.data.native_io import image_size, load_image_batch, save_png_batch
from evoworld_tpu_torch.utils.logging import get_logger


logger = logging.getLogger("evoworld_tpu_torch")  # the runtime's too


def parse_config(argv=None, doc: str | None = None) -> EvoWorldConfig:
    """The config tree with `argv`'s overrides (and the CLI's logging);
    `--help` / `-h` prints `doc`, the sections and the defaults, and exits."""
    get_logger(logger.name)
    argv = sys.argv[1:] if argv is None else argv
    if "--help" in argv or "-h" in argv:
        print(doc or __doc__ or "")
        print("Overrides: --section.field=value; sections:", ", ".join(EvoWorldConfig.__dataclass_fields__))
        print(describe(EvoWorldConfig()))
        raise SystemExit(0)
    return apply_overrides(EvoWorldConfig(), argv)


def _host(frames) -> np.ndarray:
    """A host numpy copy of a tensor (waiting for the device; never a view of
    the caller's tensor, which may change while the writer encodes), or an array."""
    if isinstance(frames, torch.Tensor):
        return frames.detach().to("cpu", copy=True).numpy()
    return np.asarray(frames)


def to_uint8(frames) -> np.ndarray:
    """(N, H, W, 3) [0, 1] floats -> uint8 by truncation; uint8 passes as it is.

    The multiply is float32 whatever the input's float type, as the JAX
    package writes it: a float64 input is rounded to float32 first, which
    can move a value just under an integer boundary by one step against a
    float64 product (it saves a float64 temporary of the whole stack).
    """
    arr = _host(frames)
    if arr.dtype == np.uint8:
        return arr
    buf = np.multiply(arr, 255.0, dtype=np.float32)  # scale first, clip in place: one temporary
    np.clip(buf, 0.0, 255.0, out=buf)
    return buf.astype(np.uint8)


def save_frames(frames, out_dir: str, start_index: int = 0, fmt: str = "{:03d}.png") -> None:
    """(N, H, W, 3) [0, 1] floats (or uint8) -> PNG files `fmt.format(start_index + i)`
    in `out_dir`, through the port's C++ encoder."""
    os.makedirs(out_dir, exist_ok=True)
    u8 = to_uint8(frames)
    save_png_batch([os.path.join(out_dir, fmt.format(start_index + i)) for i in range(len(u8))], u8)


def load_frames(paths) -> list[np.ndarray]:
    """PNG or JPEG files -> (H, W, 3) float32 arrays in [0, 1], each at its own
    size (v / 255, as PIL's decode gives it), files of one size decoded in
    one call on the thread pool."""
    sizes = [image_size(p) for p in paths]
    out: list = [None] * len(paths)
    for size in dict.fromkeys(sizes):
        idx = [i for i, s in enumerate(sizes) if s == size]
        for i, frame in zip(idx, load_image_batch([paths[i] for i in idx], *size, minus1_1=False)):
            out[i] = frame
    return out


def frames_from_minus1_1(frames) -> np.ndarray:
    return np.clip(_host(frames) / 2.0 + 0.5, 0.0, 1.0)


def _warn_unclosed(q: queue.Queue) -> None:
    warnings.warn(f"AsyncFrameWriter was never closed: {q.qsize()} queued frame stacks may be lost",
                  ResourceWarning, stacklevel=2)


class AsyncFrameWriter:
    """Background PNG writer: overlaps the host's encode with the card's compute.

    `submit` copies the frames to the host (waiting for the device) and
    enqueues them; the uint8 conversion and the encode run on the worker
    thread, whose C calls release the GIL. The queue is bounded (default 2
    pending stacks) so that a slow disk holds the loop back instead of
    piling episodes up in memory. `busy_s` counts the worker's seconds.
    `close()` drains the queue, joins the worker and raises the first
    failure, unless `submit` already raised it; callers close before they
    read the outputs or exit (the context manager does). A writer collected
    or left at exit without `close()` warns (ResourceWarning).
    """

    def __init__(self, max_pending: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=max_pending)
        self._err: BaseException | None = None
        self._surfaced = False  # the error has been raised to the caller once
        self.busy_s = 0.0
        self._thread = threading.Thread(target=self._run, name="frame-writer", daemon=True)
        self._thread.start()
        self._finalizer = weakref.finalize(self, _warn_unclosed, self._q)

    def _run(self):
        while True:
            job = self._q.get()
            if job is None:
                return
            t0 = time.perf_counter()
            try:
                save_frames(*job)
            except BaseException as e:  # noqa: BLE001 — raised to the caller by submit or close
                if self._err is None:  # the first failure is the cause; later ones follow from it
                    self._err = e
            finally:
                self.busy_s += time.perf_counter() - t0
                self._q.task_done()

    def _raise(self):
        if self._err is not None and not self._surfaced:
            self._surfaced = True
            raise self._err

    def submit(self, frames, out_dir: str, start_index: int = 0, fmt: str = "{:03d}.png"):
        self._raise()
        self._q.put((_host(frames), out_dir, start_index, fmt))

    def close(self):
        """Drain the queue, stop the worker, raise the first failure (once)."""
        self._finalizer.detach()
        if self._thread.is_alive():
            self._q.put(None)
            self._thread.join()
        self._raise()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        # Drain on error too: a partly written episode is more use than a cut one.
        self.close()
        return False
