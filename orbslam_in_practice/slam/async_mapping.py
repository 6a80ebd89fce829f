"""Asynchronous local mapping: the reference's producer/consumer split.

The reference architecture queues keyframes from Tracking to a LocalMapping
worker intended for its own thread (include/LocalMapping.h:17-22,
src/LocalMapping.cpp:61-64 — the thread itself was never spawned there;
SURVEY.md §3.5). Here it is real: Tracking enqueues the new keyframe id and
keeps tracking frames while the worker runs the mapping epoch
(cull → create → fuse → local BA → cull KFs → refresh) plus loop closing.

Rationale: a mapping epoch is a chain of device programs, and the time the
host spends waiting on them is dead time the tracking thread can use. The
LocalMapper stages are structured as assemble(lock) → device wait
(lock-free) → apply(lock, seq-validated), so the two threads interleave on
`SlamMap.lock` for host truth while their device programs pipeline on the
device. Captured jax arrays are immutable; an in-flight program never
sees a mutation (slam/map.py CONCURRENCY).

Consistency model (same as original ORB-SLAM):
- tracking frames between keyframe insertion and epoch completion run on
  the pre-epoch map (no new triangulations yet, slightly stale poses);
  the per-frame pose optimization re-converges against the moved landmarks.
- a loop closure detected by the worker rebases tracking at the next frame
  boundary (velocity reset + last_pose re-anchored through the corrected
  reference keyframe) — Tracking._consume_async_events.
"""

from __future__ import annotations

import logging
import queue
import threading

import numpy as np


class AsyncMapperDriver:
    """Owns the mapping worker thread and the keyframe queue.

    Lifecycle: one driver per Tracking instance (rebuilt on reset).
    `enqueue` never blocks; `_need_new_keyframe` throttles insertion when
    the queue is saturated (the reference's SetAcceptKeyFrames gating).
    """

    QUEUE_MAX = 2  # in-flight + pending, matching ORB-SLAM's queue<3 gate

    def __init__(self, tracker):
        self.tracker = tracker
        self._q: queue.Queue = queue.Queue()
        self._pending = 0  # queued + in-flight, guarded by _count_lock
        self._count_lock = threading.Lock()
        self._idle = threading.Event()
        self._idle.set()
        self._stop = False
        self._errors: list = []
        self._thread = threading.Thread(
            target=self._run, name="local-mapping", daemon=True
        )
        self._thread.start()

    # ---------------- producer side (tracking thread) ----------------

    def enqueue(self, smap, kf_id: int):
        with self._count_lock:
            self._pending += 1
            self._idle.clear()
        self._q.put((smap, self.tracker.mapper, kf_id))

    def pending(self) -> int:
        with self._count_lock:
            return self._pending

    def idle(self) -> bool:
        return self.pending() == 0

    def drain(self, timeout: float | None = None) -> bool:
        """Block until every queued epoch has been applied (checkpointing,
        trajectory export, reset, end-of-run)."""
        ok = self._idle.wait(timeout)
        self.raise_errors()
        return ok

    def raise_errors(self):
        if self._errors:
            err = self._errors[:]
            self._errors.clear()
            raise RuntimeError(f"async mapping worker failed: {err[0]}") from err[0]

    def shutdown(self, timeout: float = 60.0):
        self.drain(timeout)
        self._stop = True
        self._q.put(None)
        self._thread.join(timeout)

    # ---------------- consumer side (worker thread) ----------------

    def _run(self):
        while True:
            item = self._q.get()
            if item is None or self._stop:
                return
            smap, mapper, kf_id = item
            try:
                self._process(smap, mapper, kf_id)
            except Exception as e:  # surface on the tracking thread
                logging.getLogger("orbslam").exception(
                    "async mapping epoch failed (kf %d)", kf_id
                )
                self._errors.append(e)
            finally:
                with self._count_lock:
                    self._pending -= 1
                    if self._pending == 0:
                        self._idle.set()

    def _process(self, smap, mapper, kf_id: int):
        tr = self.tracker
        mapper.process_new_keyframe(smap, kf_id)
        lc = tr.loop_closer
        if lc is None:
            return
        # Loop closing runs here in the worker (in sync mode it runs inline
        # in _insert_keyframe). attempt() mutates poses/landmarks wholesale,
        # so it holds the map lock end-to-end; rare enough that the one-off
        # tracking stall is acceptable.
        with smap.lock:
            if not smap.kf_valid_host()[kf_id]:
                return
            ref_kf = tr.ref_kf
            pose_before = (
                smap.hview("kf_pose")[ref_kf].copy() if ref_kf >= 0 else None
            )
            ref_seq = int(smap.kf_seq[ref_kf]) if ref_kf >= 0 else -1
            if not lc.attempt(smap, kf_id):
                return
            # SearchAndFuse on the corrected map (same as the sync path)
            if lc.last_closure is not None:
                _, cand_c = lc.last_closure
                covis = smap.covisibility()
                nbs = [cand_c] + [
                    int(j)
                    for j in np.argsort(-covis[cand_c])[:4]
                    if covis[cand_c][j] >= 15 and j != kf_id
                ]
                if mapper.fuse_neighbors(smap, kf_id, neighbors=nbs):
                    mapper.refresh_landmarks(
                        smap, smap.keyframe_landmarks(kf_id)
                    )
            # hand the geometry jump to tracking: applied at the next frame
            # boundary under the map lock (Tracking._consume_async_events)
            tr._pending_closure_rebase = (ref_kf, ref_seq, pose_before)
