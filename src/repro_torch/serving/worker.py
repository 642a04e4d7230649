"""StreamWorker: the long-lived worker loop behind ``Engine.submit``.

(A copy of ``repro/serving/worker.py``.)

Owns every piece of streaming state -- the daemon thread, the stop/wake
events, the no-drain flag, and the dense micro-batching inbox -- so the
``Engine`` facade stays pure orchestration.  The central invariant is
*single-writer queue ownership*: the scheduler's deques (and the dense
inbox) are mutated only by whichever thread is servicing them.  That is
the worker thread while it runs, and the caller's thread in threadless
``pump()`` mode.  Consequently ``stop(drain=False)`` never cancels from
the caller: it raises a one-shot flag and the worker sheds its own queue
at the top of the next loop iteration (or, when no worker was ever
started, the cancellation runs inline because the caller *is* the
servicing thread).
"""
from __future__ import annotations

import threading
from collections import deque
from concurrent.futures import Future, InvalidStateError

from repro_torch.serving.request import Request


class StreamWorker:
    """Streaming front door for one ``Engine`` (paged or dense)."""

    def __init__(self, engine) -> None:
        self.engine = engine
        self._thread: threading.Thread | None = None
        self._stop_evt = threading.Event()
        self._wake = threading.Event()
        self._error: BaseException | None = None
        self._drain_on_stop = True
        # non-paged families stream by micro-batching through the dense
        # runtime: queued (request, future) pairs the worker drains
        self._dense_inbox: deque[tuple[Request, Future]] = deque()

    # ------------------------------------------------------------------
    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    @property
    def backlog(self) -> bool:
        """Anything submitted but not yet finished."""
        if self.engine.paged:
            return self.engine.scheduler.backlog
        return bool(self._dense_inbox)

    def submit(self, request: Request) -> Future:
        """Enqueue one request on the live stream; resolves to its
        ``GenerationResult``.  Thread-safe.  The worker loop (if started)
        or explicit ``pump()`` calls do the stepping."""
        if self._stop_evt.is_set() and self.running:
            raise RuntimeError("engine is stopping; submit refused")
        if self._error is not None:
            raise RuntimeError("engine worker died") from self._error
        if self.engine.paged:
            fut = self.engine.scheduler.submit(request)
        else:
            fut = Future()
            self._dense_inbox.append((request, fut))
        self._wake.set()
        return fut

    def pump(self) -> bool:
        """One servicing round, inline on the caller's thread: the
        deterministic-interleave alternative to ``start()`` (clusters
        round-robin ``pump`` across replicas for reproducible runs).
        Returns whether backlog remains."""
        if self.engine.paged:
            return self.engine.scheduler.service()
        if self._dense_inbox:
            batch: list[tuple[Request, Future]] = []
            while self._dense_inbox:
                batch.append(self._dense_inbox.popleft())
            try:
                results = self.engine._dense.generate([r for r, _ in batch])
            except BaseException as e:
                for _, fut in batch:
                    try:
                        fut.set_exception(e)
                    except InvalidStateError:
                        pass
                raise
            for (_, fut), res in zip(batch, results):
                try:
                    fut.set_result(res)
                except InvalidStateError:
                    pass
        return bool(self._dense_inbox)

    def start(self) -> None:
        """Start the long-lived worker loop: it steps while the queue
        drains, idles when empty, and exits via ``stop()``.  Idempotent."""
        if self.running:
            return
        self._stop_evt.clear()
        self._wake.clear()
        self._error = None
        self._drain_on_stop = True
        self._thread = threading.Thread(
            target=self._loop, name="engine-worker", daemon=True)
        self._thread.start()

    def stop(self, *, drain: bool = True) -> None:
        """Stop the worker loop.  ``drain=True`` (default) finishes every
        submitted request first; ``drain=False`` cancels queued-but-
        unstarted requests and finishes only what is already on the
        machine.  The cancellation itself runs on whichever thread owns
        the scheduler's queues: inline when no worker is running, inside
        the worker loop otherwise."""
        if not self.running:
            if not drain:
                self._cancel_queued()
            return
        self._drain_on_stop = drain
        self._stop_evt.set()
        self._wake.set()
        self._thread.join()
        self._thread = None
        if self._error is not None:
            raise RuntimeError("engine worker died") from self._error

    # ------------------------------------------------------------------
    def _cancel_queued(self) -> None:
        if self.engine.paged:
            self.engine.scheduler.cancel_queued()
            return
        kept: list[tuple[Request, Future]] = []
        while self._dense_inbox:
            r, fut = self._dense_inbox.popleft()
            if not fut.cancel():
                kept.append((r, fut))
        self._dense_inbox.extend(kept)

    def _loop(self) -> None:
        try:
            while True:
                if self._stop_evt.is_set() and not self._drain_on_stop:
                    # no-drain stop: shed the queue once (on this
                    # thread -- it owns the scheduler's queues), then
                    # fall through to finish what is on the machine
                    self._cancel_queued()
                    self._drain_on_stop = True
                busy = self.pump()
                if busy:
                    continue
                if self._stop_evt.is_set():
                    if not self.backlog:   # late submits still drain
                        break
                    continue
                # idle: settle pending Set KVC, then sleep until work
                if self.engine.paged:
                    self.engine.kv.drain_write_back()
                self._wake.wait(0.005)
                self._wake.clear()
            if self.engine.paged:
                self.engine.kv.drain_write_back()
        except BaseException as e:       # pragma: no cover - crash path
            self._error = e
            if self.engine.paged:
                self.engine.scheduler.fail_all(e)
            else:
                while self._dense_inbox:
                    _, fut = self._dense_inbox.popleft()
                    try:
                        fut.set_exception(e)
                    except InvalidStateError:
                        pass
