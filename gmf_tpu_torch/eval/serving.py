"""Micro-batching registration service on the card.

Counterpart of ``gmf_tpu/eval/serving.py``. The reference has no serving
story (its eval loop is a batch job, one pair per forward,
GMF_PointDSC/evaluation/test_3DMatch.py:24-119); a batched forward
amortises its launches over the pairs, so a service coalesces concurrent
requests into one bucket-padded forward:

- ``submit(sample) -> Future`` from any thread;
- a collector thread groups samples by shape bucket and flushes a group
  when it reaches ``max_batch`` or its oldest request has waited
  ``max_wait_ms`` (the latency bound);
- each flush is one ``PointDSCRegistrar.dispatch_batch``, padded to
  ``max_batch`` pairs so that every flush of a bucket has one shape; up to
  ``inflight`` dispatches stay pending before one is fetched. A dispatch
  here returns only once its forward is through the refinement loop, so
  the collector takes every request that queued up meanwhile before it
  flushes: they go out together, not one a flush;
- ``warmup(buckets)`` runs one forward a bucket at ``max_batch``, which
  builds the kernels and warms the allocator before the first request;
- a malformed sample fails its own future only.

Results equal direct ``register_batch`` calls on the same pairs: batching
changes when work is dispatched, not what is computed (pad rows are
copies of a real pair and their results are dropped).

Over a registrar with a mesh every rank builds the service. Rank 0 of
the mesh takes the requests and runs the flushes; before each dispatch
and each fetch it sends the command, with the flush's samples, to the
other ranks (``broadcast_object_list``), whose service threads follow:
they join the same sharded dispatch and the same fetch, and drop the
results. ``close()`` on rank 0 stops them; ``close()`` on another rank
waits for that.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Sequence

import numpy as np


class RegistrationService:
    """Thread-safe micro-batching wrapper around a PointDSCRegistrar.

    Args:
      registrar: a ``gmf_tpu_torch.eval.registration.PointDSCRegistrar``.
      max_batch: flush a bucket group at this many requests.
      max_wait_ms: flush a non-full group once its oldest request has
        waited this long (tail-latency bound).
      inflight: dispatches kept pending before forcing a fetch.
    """

    def __init__(self, registrar, max_batch: int = 16,
                 max_wait_ms: float = 10.0, inflight: int = 2):
        self.registrar = registrar
        self.max_batch = int(max_batch)
        self.max_wait = max_wait_ms / 1000.0
        self.inflight = max(1, int(inflight))
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._submit_lock = threading.Lock()  # serializes submit vs close
        mesh = getattr(registrar, "mesh", None)
        self._mesh = mesh if mesh is not None and mesh.n_data > 1 else None
        if self._mesh is not None and mesh.shape["model"] > 1:
            raise ValueError("a service over a mesh takes a 'data' axis "
                             "only (n_model = 1)")
        self.follower = (self._mesh is not None
                         and mesh.rank != mesh.ranks[0])
        self._thread = threading.Thread(
            target=self._follow if self.follower else self._run, daemon=True)
        self._thread.start()

    # -- client API ----------------------------------------------------------

    def submit(self, sample: Dict[str, np.ndarray]) -> "Future":
        """Enqueue one pair; the Future resolves to (trans, labels)."""
        if self.follower:
            raise RuntimeError("this rank follows rank 0's flushes; submit "
                               "there")
        with self._submit_lock:
            # under the lock, the shutdown sentinel cannot slip between
            # the check and the put — nothing lands after it unprocessed
            if self._stop.is_set():
                raise RuntimeError("service is closed")
            fut: Future = Future()
            self._q.put((sample, fut, time.perf_counter()))
        return fut

    def register(self, sample: Dict[str, np.ndarray]):
        """Blocking convenience: submit + wait."""
        return self.submit(sample).result()

    def warmup(self, buckets: Sequence[int], image_hw=(120, 160)) -> None:
        """One forward per bucket at ``max_batch`` pairs, the shape every
        flush is padded to, on dummy pairs: builds the kernels and warms
        the allocator before real traffic. The dummy pairs go through the
        service itself, so that the forward runs on the collector thread:
        the card's math libraries keep a handle per thread (cuDNN's takes
        a tenth of a second to create), which the first real flush would
        otherwise pay. On a following rank it does nothing: the warm-up
        flushes reach it from rank 0."""
        if self.follower:
            return
        for n in buckets:
            rng = np.random.RandomState(0)
            src = rng.rand(n, 3).astype(np.float32)
            pair = {
                "corr_pos": np.concatenate([src, src], -1),
                "src_keypts": src, "tgt_keypts": src.copy(),
                "labels": np.ones(n, np.float32),
                "gt_trans": np.eye(4, dtype=np.float32),
                "p_image": np.zeros(image_hw + (3,), np.float32),
                "q_image": np.zeros(image_hw + (3,), np.float32),
            }
            futs = [self.submit(dict(pair)) for _ in range(self.max_batch)]
            for f in futs:
                f.result()

    def close(self, timeout: float = None) -> None:
        """Drain pending work and stop the collector thread.

        Waits until the drain completes (a first request builds the
        kernels, see warmup()). Pass a numeric ``timeout`` to bound
        the wait; if the collector is still draining when it expires, a
        ``TimeoutError`` is raised rather than silently abandoning
        in-flight Futures. A following rank waits for rank 0's close."""
        with self._submit_lock:
            self._stop.set()
            self._q.put(None)  # wake the collector; last item ever queued
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            raise TimeoutError(
                f"collector still draining after {timeout}s; outstanding "
                "futures will resolve when the drain finishes")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- the ranks of a mesh -------------------------------------------------

    def _bind_device(self):
        """This thread's current card: the mesh's (the kernels launch on
        the thread's device, NCCL's objects travel through it)."""
        import torch

        if self._mesh is not None and self._mesh.device.type == "cuda":
            torch.cuda.set_device(self._mesh.device)

    def _tell(self, command) -> None:
        """Send a command to the following ranks (rank 0 only)."""
        if self._mesh is None:
            return
        import torch.distributed as dist

        dist.broadcast_object_list([command], src=self._mesh.ranks[0],
                                   group=self._mesh.group("data"))

    def _hear(self):
        import torch.distributed as dist

        box = [None]
        dist.broadcast_object_list(box, src=self._mesh.ranks[0],
                                   group=self._mesh.group("data"))
        return box[0]

    def _follow(self):
        """A following rank: join each of rank 0's dispatches and fetches
        in its order, until it stops."""
        self._bind_device()
        reg, pending = self.registrar, []
        while True:
            command = self._hear()
            if command[0] == "dispatch":
                try:
                    pending.append(reg.dispatch_batch(command[1]))
                except Exception:  # rank 0 failed the same dispatch
                    pass
            elif command[0] == "fetch":
                try:
                    reg.fetch_batch(pending.pop(0))
                except Exception:  # and failed the same fetch
                    pass
            else:
                return

    # -- collector -----------------------------------------------------------

    def _run(self):
        groups: Dict = {}      # bucket -> [(sample, fut, t_enqueue)]
        pending: List = []     # (group, handle)
        reg = self.registrar
        self._bind_device()

        def dispatch(bucket):
            group = groups.pop(bucket, [])
            if not group:
                return
            # pad every dispatch to max_batch with copies of sample 0 so
            # that each bucket runs at one shape however full the group
            # was (rows are independent in eval mode; pad-row results are
            # dropped below)
            samples = [s for s, _, _ in group]
            samples += [dict(samples[0])
                        for _ in range(self.max_batch - len(samples))]
            try:
                self._tell(("dispatch", samples))
                handle = reg.dispatch_batch(samples)
            except Exception as e:  # propagate to the callers
                for _, fut, _ in group:
                    fut.set_exception(e)
                return
            pending.append((group, handle))
            if len(pending) >= self.inflight:
                fetch_one()

        def fetch_one():
            group, handle = pending.pop(0)
            try:
                self._tell(("fetch",))
                results = reg.fetch_batch(handle)
            except Exception as e:
                for _, fut, _ in group:
                    fut.set_exception(e)
                return
            for (_, fut, _), res in zip(group, results):
                fut.set_result(res)

        def enqueue(item) -> None:
            sample, fut, t = item
            try:
                b = reg.eval_bucket([sample])
            except Exception as e:  # malformed sample: fail ITS future
                fut.set_exception(e)
                return
            groups.setdefault(b, []).append((sample, fut, t))
            if len(groups[b]) >= self.max_batch:
                dispatch(b)

        def drain_and_exit():
            # close() raced with late submit()s: anything enqueued after
            # the sentinel still gets processed, nothing hangs
            while True:
                try:
                    late = self._q.get_nowait()
                except queue.Empty:
                    break
                if late is not None:
                    enqueue(late)
            for b in list(groups):
                dispatch(b)
            while pending:
                fetch_one()
            self._tell(("stop",))

        try:
            while True:
                # deadline of the oldest queued request across groups
                now = time.perf_counter()
                deadline = min((g[0][2] + self.max_wait
                                for g in groups.values() if g),
                               default=None)
                timeout = (max(1e-4, deadline - now) if deadline is not None
                           else (0.05 if pending else None))
                try:
                    items = [self._q.get(timeout=timeout)]
                except queue.Empty:
                    items = []  # timeout tick
                # and what queued up meanwhile: a dispatch returns only
                # once its forward is through the refinement loop (it
                # syncs), so the requests that came during it are past
                # their deadline, and taken one at a time each would
                # flush alone below
                if items:
                    for _ in range(self._q.qsize()):
                        try:
                            items.append(self._q.get_nowait())
                        except queue.Empty:
                            break
                for item in items:
                    if item is None:  # close()'s sentinel, queued last
                        drain_and_exit()
                        return
                    enqueue(item)
                # flush any group past its latency deadline
                now = time.perf_counter()
                for b in [b for b, g in groups.items()
                          if g and now - g[0][2] >= self.max_wait]:
                    dispatch(b)
                # idle: drain one pending fetch so results don't sit forever
                if not items and pending:
                    fetch_one()
        except BaseException as e:  # collector must never die silently
            # under _submit_lock: a concurrent submit() either finished
            # its put before we drain below (we fail its future here) or
            # observes _stop afterwards and raises — nothing can land in
            # the queue after the final drain and hang forever
            with self._submit_lock:
                self._stop.set()
                for g in groups.values():
                    for _, fut, _ in g:
                        if not fut.done():
                            fut.set_exception(e)
                for group, _ in pending:
                    for _, fut, _ in group:
                        if not fut.done():
                            fut.set_exception(e)
                while True:
                    try:
                        late = self._q.get_nowait()
                    except queue.Empty:
                        break
                    if late is not None and not late[1].done():
                        late[1].set_exception(e)
            try:
                self._tell(("stop",))
            except Exception:
                pass
            raise
