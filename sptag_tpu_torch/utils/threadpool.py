"""ThreadPool — background job queue with the reference's surface (port of
``sptag_tpu/utils/threadpool.py``).

Helper::ThreadPool: ``init(threads)`` spawns workers draining a shared job
queue; ``add(job)`` enqueues a plain callable; ``current_jobs()`` counts
the queued jobs and ``join()`` waits for them.  The BKT and KDT indexes run
their single background worker on it: the tree rebuild after
``AddCountForRebuild`` adds, and the delta shard's link + engine swap.

Concurrency contract: ``_stopped`` and the queue change together under
``_lock``, so every job ``add()`` accepts runs before the stop sentinels.
``stop()`` is idempotent, joins its workers outside the lock (a running
job may need its owner's lock to finish) and reports workers that outlive
the join timeout in a warning and the ``threadpool.leaked_workers``
counter; ``init()`` on a stopped pool raises.  The lock is a lock-sanitizer
``SanLock`` when ``SPTAG_LOCKSAN`` (or the service's LockSanitizer) is on
(utils/locksan.py).
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Callable, Optional

from sptag_tpu_torch.utils import locksan, metrics

log = logging.getLogger(__name__)


class ThreadPool:
    def __init__(self, name: str = "pool"):
        self.name = name
        self._queue: "queue.Queue[Optional[Callable[[], None]]]" = \
            queue.Queue()
        self._workers: list = []
        self._stopped = False
        self._lock = locksan.make_lock("ThreadPool._lock")

    def init(self, threads: int = 1) -> None:
        """Spawn `threads` daemon workers; RuntimeError on a stopped pool
        (its queue ends in sentinels)."""
        with self._lock:
            if self._stopped:
                raise RuntimeError(
                    f"ThreadPool {self.name!r} is stopped; create a new "
                    "pool instead of re-initializing it")
            for _ in range(max(1, threads)):
                t = threading.Thread(
                    target=self._run, daemon=True,
                    name=f"{self.name or 'pool'}-worker-"
                         f"{len(self._workers)}")
                t.start()
                self._workers.append(t)

    def add(self, job: Callable[[], None]) -> None:
        """Enqueue a job; flag check and enqueue are one atomic step."""
        with self._lock:
            if self._stopped:
                raise RuntimeError(f"ThreadPool {self.name!r} is stopped")
            self._queue.put_nowait(job)

    def current_jobs(self) -> int:
        """Jobs queued and not yet started, approximately (SPTAG's
        ThreadPool::jobsize)."""
        return self._queue.qsize()

    def join(self) -> None:
        """Block until every queued job has finished."""
        self._queue.join()

    def stop(self, join_timeout_s: float = 10.0) -> None:
        """Drain and terminate the workers (idempotent).  A worker still
        running a wedged job after `join_timeout_s` is abandoned (it is a
        daemon) with a warning naming the pool."""
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            workers, self._workers = self._workers, []
            for _ in workers:
                self._queue.put_nowait(None)
        leaked = 0
        for t in workers:
            t.join(timeout=join_timeout_s)
            if t.is_alive():
                leaked += 1
        if leaked:
            metrics.inc("threadpool.leaked_workers", leaked)
            log.warning(
                "ThreadPool %r: %d worker(s) still running %.1fs after "
                "stop(); job wedged, daemon thread(s) abandoned",
                self.name, leaked, join_timeout_s)

    def _run(self) -> None:
        while True:
            job = self._queue.get()
            if job is None:
                self._queue.task_done()
                return
            try:
                job()
            except Exception:                          # noqa: BLE001
                log.exception("ThreadPool %r job failed", self.name)
            finally:
                self._queue.task_done()
                # drop the reference before blocking in get(): a bound
                # method would pin its owner while the worker idles
                job = None
