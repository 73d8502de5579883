"""Checkpoint engine plug-ins.

Counterpart of ``deepspeed_tpu/runtime/checkpoint_engine/checkpoint_engine.py``:
an engine owns how leaf arrays get persisted.  The native engine writes
``.npy`` files; the async engine takes host copies and writes them on one
background thread, so the train loop is not blocked on the disk (the Nebula
tier-1 behaviour).  Both take numpy arrays: the caller moves tensors to the
host first.

Save protocol contract (``runtime/checkpointing.save_checkpoint_dir``):
leaves are written with ``save()``, then ``flush()`` must make every pending
write visible (the async engine drains its queue here), then, after the
staging dir has been renamed to its final tag, ``commit(tag)`` marks the tag
durable.  ``commit`` therefore always sees a complete, manifest-bearing
checkpoint directory.
"""

import os
import queue
import threading
from typing import Optional

import numpy as np


class CheckpointEngine:
    """Persistence strategy for checkpoint leaves."""

    # file-backed engines that persist plain .npy at the target path; the JAX
    # package streams sharded leaves into such files, which one GPU never has
    supports_streaming_save = False

    def makedirs(self, path: str):
        os.makedirs(path, exist_ok=True)

    def save(self, arr: np.ndarray, path: str) -> None:
        raise NotImplementedError

    def load(self, path: str) -> np.ndarray:
        raise NotImplementedError

    def flush(self) -> None:
        """Make every ``save()`` issued so far visible on disk (the barrier
        before the manifest is written and the staging dir renamed).
        Synchronous engines are already flushed; async engines drain their
        queue."""

    def commit(self, tag: str) -> bool:
        """Mark ``tag`` durable; called after the checkpoint dir is complete
        (leaves + metadata.json in final position).  Returns True when durable."""
        return True


class NativeCheckpointEngine(CheckpointEngine):
    """Synchronous .npy writer (TorchCheckpointEngine analog)."""

    supports_streaming_save = True

    def save(self, arr: np.ndarray, path: str) -> None:
        np.save(path, arr)

    def load(self, path: str) -> np.ndarray:
        return np.load(path)


class AsyncCheckpointEngine(CheckpointEngine):
    """Background-thread writer (NebulaCheckpointEngine analog): ``save()``
    enqueues an array already on the host and returns at once;
    ``flush()``/``commit()`` drain the queue.  One writer thread keeps the
    write order."""

    supports_streaming_save = True

    def __init__(self, max_queue: int = 64):
        self._queue: "queue.Queue" = queue.Queue(maxsize=max_queue)
        # _error crosses the worker/caller boundary: written by the worker on
        # a failed write, swapped out by _raise_pending() on the caller side,
        # both under _error_lock
        self._error_lock = threading.Lock()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._queue.get()
            if item is None:
                return
            arr, path = item
            try:
                np.save(path, arr)
            except BaseException as exc:  # surfaced at flush()/commit()
                with self._error_lock:
                    self._error = exc
            finally:
                self._queue.task_done()

    def _raise_pending(self):
        """Re-raise the writer thread's failure with its own type (an
        ``OSError`` from a flaky mount stays an ``OSError``, so the save retry
        loop recognizes it as transient) and clear it, so that a retried save
        starts clean."""
        with self._error_lock:
            exc, self._error = self._error, None
        if exc is not None:
            raise exc

    def save(self, arr: np.ndarray, path: str) -> None:
        self._raise_pending()
        self._queue.put((np.asarray(arr), path))

    def load(self, path: str) -> np.ndarray:
        return np.load(path)

    def flush(self) -> None:
        self._queue.join()
        self._raise_pending()

    def commit(self, tag: str) -> bool:
        self.flush()
        return True

    def close(self):
        self._queue.join()
        self._queue.put(None)
        self._thread.join()


def build_checkpoint_engine(kind: str = "native", max_queue: int = 64) -> CheckpointEngine:
    if kind in ("native", "torch"):
        return NativeCheckpointEngine()
    if kind in ("async", "nebula"):
        return AsyncCheckpointEngine(max_queue=max_queue)
    raise ValueError(f"unknown checkpoint engine '{kind}' (native|async)")
