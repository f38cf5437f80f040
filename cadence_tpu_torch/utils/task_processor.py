"""Keyed sequential task processing.

Reference: common/task/sequentialTaskProcessor.go — tasks that share a
key (a workflow run, a shard, a partition) must execute in submission
order, while distinct keys spread over a fixed worker pool. The
reference backs its replication task processing with this; here the
replication consumers (runtime/replication/processor.py) do the same.

Design: one dict of per-key FIFO deques. The first submit for an idle
key claims it and schedules a drainer on the pool; the drainer runs
that key's tasks in order until the deque empties, then releases the
key. A task that raises is logged and dropped — ordering of the
SURVIVING tasks is preserved, and the caller can wait on a per-batch
barrier via :meth:`flush`.

A copy of the reference package's ``utils/task_processor.py``.
"""

from __future__ import annotations

import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Deque, Dict, Hashable, Optional

from .log import get_logger


class KeyedSequentialProcessor:
    def __init__(
        self, worker_count: int = 4, name: str = "keyed",
        on_error: Optional[Callable[[Hashable, BaseException], None]] = None,
    ) -> None:
        self._pool = ThreadPoolExecutor(
            max_workers=worker_count, thread_name_prefix=f"{name}-seq"
        )
        self._lock = threading.Lock()
        self._queues: Dict[Hashable, Deque[Callable[[], None]]] = {}
        self._idle = threading.Condition(self._lock)
        self._pending = 0
        self._log = get_logger(f"cadence_tpu_torch.task.{name}")
        self._on_error = on_error
        self._shutdown = False

    def submit(self, key: Hashable, fn: Callable[[], None]) -> None:
        """Run ``fn`` after every previously submitted task of ``key``;
        tasks of other keys run concurrently."""
        with self._lock:
            if self._shutdown:
                raise RuntimeError("processor is shut down")
            self._pending += 1
            q = self._queues.get(key)
            if q is not None:
                q.append(fn)
                return
            self._queues[key] = deque([fn])
            # under the lock: keeps the shutdown check and the pool
            # submission atomic vs shutdown() (pool.submit never blocks
            # on task execution, so holding the lock here is safe)
            try:
                self._pool.submit(self._drain_key, key)
            except BaseException:
                self._pending -= 1
                del self._queues[key]
                raise

    def _drain_key(self, key: Hashable) -> None:
        while True:
            with self._lock:
                q = self._queues[key]
                if not q:
                    del self._queues[key]
                    return
                fn = q.popleft()
            try:
                fn()
            except Exception as e:
                if self._on_error is not None:
                    try:
                        self._on_error(key, e)
                    except Exception:
                        self._log.exception("on_error callback failed")
                else:
                    self._log.exception(f"task for key {key!r} raised")
            except BaseException:
                # SystemExit/KeyboardInterrupt reaching a worker would
                # otherwise leave the key claimed with a drainer-less
                # queue: that key's tasks silently stop applying and
                # flush() never returns. Drop the key's queue (its
                # pending count included), then let the executor
                # surface it.
                with self._lock:
                    dropped = self._queues.pop(key, None)
                    self._pending -= len(dropped) if dropped else 0
                raise
            finally:
                with self._lock:
                    self._pending -= 1
                    if self._pending == 0:
                        self._idle.notify_all()

    def flush(self, timeout_s: float = 30.0) -> bool:
        """Block until every task submitted so far has finished."""
        with self._lock:
            return self._idle.wait_for(
                lambda: self._pending == 0, timeout=timeout_s
            )

    def pending(self) -> int:
        with self._lock:
            return self._pending

    @property
    def is_shutdown(self) -> bool:
        with self._lock:
            return self._shutdown

    def shutdown(self, wait: bool = True) -> None:
        with self._lock:
            self._shutdown = True
        self._pool.shutdown(wait=wait)
