"""World model: fixed-shape array map (keyframes, landmarks, observations).

Replaces the reference's pointer graph — Map's std::sets (include/Map.h:28-29),
KeyFrame's per-object members (include/KeyFrame.h), MapPoint's observation
std::map (include/MapPoint.h:61) — with slot-allocated arrays
(SURVEY.md §7.1 design stance):

- keyframe table: poses + per-keyframe feature arrays + obs (feature ->
  landmark id) — the observation structure IS the (KF, feature) -> landmark
  index array, so covisibility is one matmul away.
- landmark table: position, representative descriptor, normal, distance
  invariants (the reference declared but never defined UpdateNormalAndDepth /
  ComputeDistinctiveDescriptors — SURVEY.md §2.4; here they are real,
  slam/local_mapping.py).
- covisibility: shared-observation counts M @ M^T (KeyFrame::UpdateConnections
  semantics, src/KeyFrame.cpp:54-116, threshold th=15 applied by consumers),
  with the reference's self-edge bug (:97,103) structurally impossible.

HOST-TRUTH / DEVICE-MIRROR design (round 3; the perf lesson of
tools/profile_mapping.py): every mutation is a numpy write on the host copy
— zero device work, zero new XLA programs — and each table's device mirror
is refreshed lazily, as ONE fixed-shape whole-table transfer, the next time
a jitted consumer reads it. Previously each mutation was a device
scatter/gather whose index length varied per call, so every keyframe epoch
minted dozens of unique program shapes, each compiled on first use. The
big descriptor table
(k_max, f_max, 256) refreshes per dirty ROW via one cached fixed-shape
row-set program instead of re-uploading 64 MB.

The public attribute API is unchanged: `smap.kf_pose` etc. are properties
returning the (refreshed) device mirror, and assigning them writes host
truth. Jitted consumers read the same names they always did. Host-side code
should read `smap.hview("name")` — the numpy truth, no transfer at all.

Slot lifecycle (long-sequence viability — the reference's map grows
unboundedly, include/Map.h:28-29; fixed shapes need recycling):
- freed keyframe/landmark slots go on free lists and are reallocated;
- landmark frees are *quarantined* until the next keyframe insertion so ids
  cached by the tracker between frames can never silently re-bind to a new
  landmark within the same mapping epoch;
- `kf_seq` gives every keyframe a monotonic insertion number (the reference's
  static id counter, src/KeyFrame.cpp:5) — all ordering-sensitive logic
  (loop temporal guard, gauge choice, culling exemptions) uses kf_seq, never
  slot ids;
- `lm_uid` gives every landmark allocation a generation tag so stale id
  references are detectable after recycling.

Mutation is host-driven (single-writer — the reference had shared mutable
state and zero locks, SURVEY.md §5 race-detection note); hot queries
(covisibility, local-map assembly) are jitted against the device mirrors.

CONCURRENCY (round 5, async local mapping — the producer/consumer split the
reference intended for its mapping thread, include/LocalMapping.h:17-22):
`self.lock` (an RLock) guards ALL host-truth reads/writes and mirror-cache
(`_dev`/_dirty) access. The tracking thread and the mapping worker hold it
for their host sections and release it across device waits — safe because
captured jax arrays are immutable, so an in-flight device program never
observes a mutation. Synchronous mode takes the same lock uncontended
(nanoseconds). The single-writer discipline per table is unchanged; the
lock serializes WHICH single writer runs.
"""

from __future__ import annotations

import threading
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@partial(jax.jit, static_argnames=("l_max",))
def _covis_matrix(kf_obs: jnp.ndarray, kf_valid: jnp.ndarray, l_max: int):
    """Shared-landmark counts between keyframes: (K, K) int32.

    kf_obs: (K, F) landmark id or -1. One one-hot matmul.
    """
    k, f = kf_obs.shape
    sees = jnp.zeros((k, l_max), jnp.float32)
    kf_idx = jnp.broadcast_to(jnp.arange(k)[:, None], (k, f))
    valid = (kf_obs >= 0) & kf_valid[:, None]
    sees = sees.at[kf_idx, jnp.maximum(kf_obs, 0)].max(valid.astype(jnp.float32))
    counts = sees @ sees.T  # (K, K)
    counts = counts * (1.0 - jnp.eye(k))
    return counts.astype(jnp.int32)


@jax.jit
def _row_set(arr: jnp.ndarray, k: jnp.ndarray, row: jnp.ndarray):
    """ONE cached program for updating a single table row (k is traced, so
    every row index reuses the same executable)."""
    return arr.at[k].set(row)


# device-mirrored tables: name -> np dtype; all are whole-table refreshed
# except the per-keyframe FEATURE tables (row policy — see class docstring).
# Those five are mutated only one row at a time (insert_keyframe /
# remove_keyframe), so refreshing their mirrors is a handful of row-set
# programs instead of re-uploading megabytes — which lets the mapping kernels read
# them as device-resident tables for free. kf_obs stays whole-table: it is
# scatter-mutated across arbitrary rows (fusion, erasure, culling).
_MIRRORED = (
    "kf_pose", "kf_valid", "kf_xy", "kf_octave", "kf_angle",
    "kf_feat_valid", "kf_desc_pm1", "kf_obs", "kf_gdesc",
    "lm_pos", "lm_valid", "lm_desc_pm1", "lm_normal",
    "lm_min_dist", "lm_max_dist", "lm_octave",
)
_ROW_POLICY = {
    "kf_desc_pm1", "kf_xy", "kf_octave", "kf_angle", "kf_feat_valid",
    "kf_gdesc",
}
# Landmark tables use BATCHED row policy: every mutation carries an explicit
# id list (add/erase/invariant-refresh/position write-back), typically a few
# hundred rows per keyframe against an l_max x 256 descriptor table whose
# whole-table refresh is ~4 MB. The dirty id set
# is applied as ONE bucket-padded scatter program per table; a mutation
# touching more than l_max/4 rows promotes to a whole-table refresh.
_BATCH_ROW_POLICY = {
    "lm_pos", "lm_valid", "lm_desc_pm1", "lm_normal",
    "lm_min_dist", "lm_max_dist", "lm_octave",
}


@jax.jit
def _rows_set(arr: jnp.ndarray, ks: jnp.ndarray, rows: jnp.ndarray):
    """ONE cached program per (table, bucket) shape for scattering a padded
    batch of rows (duplicate padded indices carry identical rows)."""
    return arr.at[ks].set(rows)


@jax.jit
def _flush_rows_multi(kf_arrays, kf_ids, kf_rows, lm_arrays, lm_ids, lm_rows):
    """Apply pending row updates to MANY mirror tables in ONE device
    program. Each table updated separately is one more dispatch; a keyframe
    epoch dirties ~6 keyframe-row tables + ~7 landmark-row tables, so
    coalescing turns ~13 dispatches per keyframe into one."""
    kf_out = tuple(a.at[kf_ids].set(r) for a, r in zip(kf_arrays, kf_rows))
    lm_out = tuple(a.at[lm_ids].set(r) for a, r in zip(lm_arrays, lm_rows))
    return kf_out, lm_out


class SlamMap:
    """Slot-allocated map: numpy host truth + lazy jnp device mirrors."""

    def __init__(
        self,
        k_max: int = 256,
        l_max: int = 16384,
        f_max: int = 1024,
        desc_dim: int = 256,
    ):
        self.k_max = k_max
        self.l_max = l_max
        self.f_max = f_max
        # guards host truth + mirror caches (see module docstring CONCURRENCY)
        self.lock = threading.RLock()
        self.n_kf = 0  # slot high-water mark (slots [0, n_kf) may be invalid)
        self.n_lm = 0  # slot high-water mark
        self.next_kf_id = 0  # monotonically increasing (ref src/KeyFrame.cpp:5)

        eye = np.eye(4, dtype=np.float32)
        self._kf_pose = np.tile(eye, (k_max, 1, 1))
        self._kf_valid = np.zeros(k_max, bool)
        self.kf_frame_id = np.full(k_max, -1, np.int64)  # source frame index
        self.kf_seq = np.full(k_max, -1, np.int64)  # monotonic insertion order
        self._kf_xy = np.zeros((k_max, f_max, 2), np.float32)
        self._kf_octave = np.zeros((k_max, f_max), np.int32)
        self._kf_angle = np.zeros((k_max, f_max), np.float32)
        self._kf_feat_valid = np.zeros((k_max, f_max), bool)
        self._kf_desc_pm1 = np.zeros((k_max, f_max, desc_dim), np.int8)
        self._kf_obs = np.full((k_max, f_max), -1, np.int32)
        # global place-recognition descriptor per keyframe (mean-of-BRIEF,
        # slam/place_recognition.py — the VLAD variants measured WORSE, see
        # tools/gdesc_experiment.py) — computed once at insertion (features
        # are immutable post-insert), L2-normalized
        from orbslam_in_practice.slam.place_recognition import GDESC_DIM

        self._kf_gdesc = np.zeros((k_max, GDESC_DIM), np.float32)

        self._lm_pos = np.zeros((l_max, 3), np.float32)
        self._lm_valid = np.zeros(l_max, bool)
        self._lm_desc_pm1 = np.zeros((l_max, desc_dim), np.int8)
        self._lm_normal = np.zeros((l_max, 3), np.float32)
        self._lm_min_dist = np.zeros(l_max, np.float32)
        self._lm_max_dist = np.full(l_max, np.inf, np.float32)
        self._lm_octave = np.zeros(l_max, np.int32)
        self.lm_first_kf = np.full(l_max, -1, np.int32)
        self.lm_uid = np.full(l_max, -1, np.int64)  # allocation generation tag
        self.lm_obs_count = np.zeros(l_max, np.int32)
        self.lm_found_count = np.zeros(l_max, np.int32)  # visible->matched ratio
        self.lm_visible_count = np.zeros(l_max, np.int32)
        self._next_lm_uid = 0
        # free lists (recycled slots). Landmark frees sit in quarantine until
        # the next keyframe insertion (see module docstring).
        self._kf_free: list = []
        self._lm_free: list = []
        self._lm_free_pending: list = []
        # incremental covisibility (VERDICT r4 next #2; the reference keeps
        # per-KF weight maps incremental by design, src/KeyFrame.cpp:54-116):
        # _sees[k, l] = keyframe k has >=1 feature bound to landmark l, and
        # _covis[i, j] = #{l : _sees[i,l] & _sees[j,l]} (diagonal zero).
        # Every observation mutation applies its closed-form delta; the full
        # (n_kf x l_max) sgemm rebuild happens only when host truth is
        # replaced wholesale (checkpoint load / test setters).
        self._sees = np.zeros((k_max, l_max), bool)
        self._covis = np.zeros((k_max, k_max), np.int32)
        self._covis_dirty = False  # full rebuild required
        # device-mirror state
        self._dev: dict = {}
        self._dirty = set(_MIRRORED)
        self._dirty_rows: dict = {
            n: set() for n in (_ROW_POLICY | _BATCH_ROW_POLICY)
        }

    # ---------------- device mirrors ----------------

    def _mirror(self, name: str):
        host = getattr(self, "_" + name)
        if name in self._dirty or name not in self._dev:
            self._dev[name] = jnp.asarray(host)
            self._dirty.discard(name)
            if name in self._dirty_rows:
                self._dirty_rows[name].clear()
        elif name in _ROW_POLICY and self._dirty_rows[name]:
            dev = self._dev[name]
            for k in sorted(self._dirty_rows[name]):
                dev = _row_set(dev, jnp.asarray(k), jnp.asarray(host[k]))
            self._dev[name] = dev
            self._dirty_rows[name].clear()
        elif name in _BATCH_ROW_POLICY and self._dirty_rows[name]:
            ids = np.fromiter(self._dirty_rows[name], np.int32)
            ids.sort()
            B = max(64, int(2 ** np.ceil(np.log2(len(ids)))))
            ids_pad = np.full(B, ids[0], np.int32)
            ids_pad[: len(ids)] = ids
            self._dev[name] = _rows_set(
                self._dev[name], jnp.asarray(ids_pad), jnp.asarray(host[ids_pad])
            )
            self._dirty_rows[name].clear()
        return self._dev[name]

    def _touch(self, *names: str):
        """Mark whole tables dirty (next mirror read re-uploads)."""
        for n in names:
            self._dirty.add(n)

    def _touch_row(self, name: str, k: int):
        if name in self._dirty:
            return  # full refresh already pending
        self._dirty_rows[name].add(int(k))

    def _touch_rows(self, ids, *names: str):
        """Mark a batch of rows dirty on batched-row-policy tables; a batch
        larger than l_max/4 promotes to a whole-table refresh."""
        idl = [int(i) for i in np.asarray(ids).ravel()]
        for n in names:
            if n in self._dirty:
                continue
            rows = self._dirty_rows[n]
            rows.update(idl)
            if len(rows) > self.l_max // 4:
                self._dirty.add(n)
                rows.clear()

    def flush_mirrors(self):
        """Coalesce ALL pending row-policy / batched-row mirror updates into
        one device program (vs one lazy program per table on first read).
        Call at the end of a mapping epoch, before tracking resumes: the
        next fused tracking frame reads the 7 landmark mirrors and would
        otherwise trigger 7 separate scatter programs. Tables pending a
        WHOLE-table refresh (in _dirty) are left to the lazy path."""

        def gather(policy):
            names = [
                n
                for n in sorted(policy)
                if n in self._dev
                and n not in self._dirty
                and self._dirty_rows[n]
            ]
            if not names:
                return [], None, []
            union = sorted(set().union(*[self._dirty_rows[n] for n in names]))
            B = max(8, int(2 ** np.ceil(np.log2(len(union)))))
            ids = np.full(B, union[0], np.int64)
            ids[: len(union)] = union
            rows = [getattr(self, "_" + n)[ids] for n in names]
            return names, ids, rows

        kf_names, kf_ids, kf_rows = gather(_ROW_POLICY)
        lm_names, lm_ids, lm_rows = gather(_BATCH_ROW_POLICY)
        if not kf_names and not lm_names:
            return
        kf_out, lm_out = _flush_rows_multi(
            tuple(self._dev[n] for n in kf_names),
            jnp.asarray(kf_ids if kf_ids is not None else np.zeros(0, np.int64)),
            tuple(jnp.asarray(r) for r in kf_rows),
            tuple(self._dev[n] for n in lm_names),
            jnp.asarray(lm_ids if lm_ids is not None else np.zeros(0, np.int64)),
            tuple(jnp.asarray(r) for r in lm_rows),
        )
        for n, o in zip(kf_names, kf_out):
            self._dev[n] = o
            self._dirty_rows[n].clear()
        for n, o in zip(lm_names, lm_out):
            self._dev[n] = o
            self._dirty_rows[n].clear()

    def hview(self, name: str) -> np.ndarray:
        """The numpy host truth of a mirrored table — READ-ONLY by contract
        (mutate through the map's methods so mirrors stay coherent)."""
        return getattr(self, "_" + name)

    def _invalidate_caches(self):
        """Mark the covisibility structures for a FULL rebuild — only for
        wholesale host-truth replacement (checkpoint load, test setters).
        Normal mutation paths apply closed-form deltas instead."""
        self._covis_dirty = True

    def _covis_rebuild(self):
        """Rebuild _sees and _covis from the observation truth (one BLAS
        sgemm). Cost model in covisibility()'s docstring."""
        self._sees[:] = False
        n = self.n_kf
        if n:
            obs = self._kf_obs[:n]
            mask = (obs >= 0) & self._kf_valid[:n, None]
            kf_idx, feat_idx = np.nonzero(mask)
            self._sees[kf_idx, obs[kf_idx, feat_idx]] = True
            s = self._sees[:n].astype(np.float32)
            counts = (s @ s.T).astype(np.int32)
            np.fill_diagonal(counts, 0)
            self._covis[:] = 0
            self._covis[:n, :n] = counts
        else:
            self._covis[:] = 0
        self._covis_dirty = False

    def _covis_add(self, k: int, lm_ids: np.ndarray):
        """Keyframe k gains first-time observations of (possibly duplicate)
        lm_ids: symmetric row/col delta from the landmarks' other observers."""
        if self._covis_dirty:
            return  # rebuilt wholesale on next read anyway
        new = np.unique(np.asarray(lm_ids, np.int64))
        new = new[~self._sees[k, new]]
        if len(new) == 0:
            return
        n = self.n_kf
        d = self._sees[:n, new].sum(axis=1).astype(np.int32)
        self._covis[k, :n] += d
        self._covis[:n, k] += d
        self._sees[k, new] = True
        self._covis[k, k] = 0

    def _covis_remove(self, k: int, lm_ids: np.ndarray):
        """Keyframe k lost its LAST feature binding for each of lm_ids
        (caller guarantees); symmetric decrement."""
        if self._covis_dirty:
            return
        gone = np.unique(np.asarray(lm_ids, np.int64))
        gone = gone[self._sees[k, gone]]
        if len(gone) == 0:
            return
        self._sees[k, gone] = False  # first, so d excludes k itself
        n = self.n_kf
        d = self._sees[:n, gone].sum(axis=1).astype(np.int32)
        self._covis[k, :n] -= d
        self._covis[:n, k] -= d

    def _covis_scrub(self, kf_idx: np.ndarray, lm_vals: np.ndarray):
        """Observation removals at (kf, landmark) pairs AFTER _kf_obs was
        updated: drop sees edges only where no other feature of the keyframe
        still binds the landmark (duplicate-binding safe)."""
        if self._covis_dirty or len(kf_idx) == 0:
            return
        for k in np.unique(kf_idx):
            lms = np.unique(lm_vals[kf_idx == k])
            row = self._kf_obs[k]
            present = np.zeros(self.l_max, bool)
            row_seen = row[row >= 0]
            present[row_seen] = True
            self._covis_remove(int(k), lms[~present[lms]])

    def _covis_erase_landmarks(self, lm_ids: np.ndarray):
        """Landmarks fully erased across all keyframes: one small sgemm over
        the (n_kf, L) slice of sees."""
        if self._covis_dirty or len(lm_ids) == 0:
            return
        n = self.n_kf
        S = self._sees[:n, lm_ids]
        cols = S.any(axis=0)
        if cols.any():
            Sf = S[:, cols].astype(np.float32)
            delta = (Sf @ Sf.T).astype(np.int32)
            np.fill_diagonal(delta, 0)
            self._covis[:n, :n] -= delta
        self._sees[:, lm_ids] = False

    def _covis_remove_keyframe(self, k: int):
        if self._covis_dirty:
            return
        self._covis[k, :] = 0
        self._covis[:, k] = 0
        self._sees[k, :] = False

    def _covis_replace_landmark(self, loser: int, winner: int):
        """Merge: winner's observer set becomes the union; loser vanishes.
        delta = outer(C,C) - outer(A,A) - outer(B,B) with C = A|B."""
        if self._covis_dirty:
            return
        n = self.n_kf
        A = self._sees[:n, loser].astype(np.int32)
        B = self._sees[:n, winner].astype(np.int32)
        C = A | B
        delta = np.outer(C, C) - np.outer(A, A) - np.outer(B, B)
        np.fill_diagonal(delta, 0)
        self._covis[:n, :n] += delta
        self._sees[:n, loser] = False
        self._sees[:n, winner] = C.astype(bool)

    # legacy host accessors (kept for call-site compatibility; now free)
    def kf_obs_host(self) -> np.ndarray:
        return self._kf_obs

    def lm_valid_host(self) -> np.ndarray:
        return self._lm_valid

    def kf_valid_host(self) -> np.ndarray:
        return self._kf_valid

    # ---------------- counts / capacity ----------------

    def n_kf_active(self) -> int:
        return int(self._kf_valid[: self.n_kf].sum())

    def n_lm_active(self) -> int:
        return int(self._lm_valid[: self.n_lm].sum())

    def keyframe_capacity(self) -> int:
        return (self.k_max - self.n_kf) + len(self._kf_free)

    def landmark_capacity(self) -> int:
        return (self.l_max - self.n_lm) + len(self._lm_free)

    def valid_keyframes_by_seq(self) -> np.ndarray:
        """Valid keyframe slot ids ordered by insertion sequence (temporal
        order — robust to slot recycling)."""
        valid = self._kf_valid[: self.n_kf]
        ids = np.nonzero(valid)[0]
        return ids[np.argsort(self.kf_seq[ids], kind="stable")]

    # ---------------- keyframes ----------------

    def add_keyframe(self, frame, Tcw, obs: np.ndarray, frame_id: int) -> int:
        """Insert a Frame snapshot (ref KeyFrame ctor src/KeyFrame.cpp:11-17).

        obs: (F,) int32 landmark id per feature (-1 = none).
        Returns the keyframe slot id.
        """
        # a keyframe insertion starts a new mapping epoch: quarantined
        # landmark frees become allocatable
        if self._lm_free_pending:
            self._lm_free.extend(self._lm_free_pending)
            self._lm_free_pending = []
        if self._kf_free:
            k = self._kf_free.pop()
        elif self.n_kf < self.k_max:
            k = self.n_kf
            self.n_kf += 1
        else:
            raise RuntimeError("keyframe table full (k_max); evict first")
        nf = frame.n_features
        if nf > self.f_max:
            raise ValueError(f"frame has {nf} features > map f_max {self.f_max}")

        # ONE device->host transfer for the whole frame snapshot (the global
        # place descriptor is computed on device from the frame arrays and
        # rides the same transfer)
        from orbslam_in_practice.slam.place_recognition import (
            global_descriptor,
        )

        xy, octave, angle, fvalid, desc, gdesc = jax.device_get(
            (
                frame.xy, frame.octave, frame.angle, frame.valid,
                frame.desc_pm1,
                global_descriptor(frame.desc_pm1, frame.valid),
            )
        )
        self._kf_pose[k] = np.asarray(Tcw)
        self._kf_valid[k] = True
        self.kf_frame_id[k] = frame_id
        self.kf_seq[k] = self.next_kf_id
        self._kf_xy[k, :nf] = xy
        self._kf_xy[k, nf:] = 0.0
        self._kf_octave[k, :nf] = octave
        self._kf_octave[k, nf:] = 0
        self._kf_angle[k, :nf] = angle
        self._kf_angle[k, nf:] = 0.0
        self._kf_feat_valid[k, :nf] = fvalid
        self._kf_feat_valid[k, nf:] = False
        self._kf_desc_pm1[k, :nf] = desc
        self._kf_desc_pm1[k, nf:] = 0
        self._kf_gdesc[k] = gdesc

        obs_row = np.full(self.f_max, -1, np.int32)
        obs_row[:nf] = np.asarray(obs, np.int32)[:nf]
        obs_row[~self._kf_feat_valid[k]] = -1
        self._kf_obs[k] = obs_row
        # bump landmark observation counts
        seen = obs_row[obs_row >= 0]
        np.add.at(self.lm_obs_count, seen, 1)
        self._covis_add(k, seen)
        self.next_kf_id += 1
        self._touch("kf_pose", "kf_valid", "kf_obs")
        for n in (
            "kf_desc_pm1", "kf_xy", "kf_octave", "kf_angle", "kf_feat_valid",
            "kf_gdesc",
        ):
            self._touch_row(n, k)
        return k

    def set_kf_poses(self, kf_ids, poses):
        self._kf_pose[np.asarray(kf_ids)] = np.asarray(poses, np.float32)
        self._touch("kf_pose")

    # ---------------- landmarks ----------------

    def allocate_landmarks(self, n: int) -> np.ndarray:
        """Allocate up to n slots (recycled first, then fresh); silently
        truncates at capacity — callers size their work by the returned ids.
        Slots are tagged with a fresh generation uid (lm_uid)."""
        n = min(n, self.landmark_capacity())
        n_recycled = min(n, len(self._lm_free))
        recycled = [self._lm_free.pop() for _ in range(n_recycled)]
        n_fresh = n - n_recycled
        fresh = np.arange(self.n_lm, self.n_lm + n_fresh, dtype=np.int32)
        self.n_lm += n_fresh
        ids = np.concatenate([np.asarray(recycled, np.int32), fresh])
        self.lm_uid[ids] = np.arange(
            self._next_lm_uid, self._next_lm_uid + len(ids), dtype=np.int64
        )
        self._next_lm_uid += len(ids)
        return ids

    def _free_landmark_slots(self, ids: np.ndarray):
        """Return fully-dereferenced landmark slots to the (quarantined)
        free list. Callers must already have cleared all kf_obs references.
        Idempotent: uid == -1 marks an already-freed slot (double-freeing
        would hand the same slot to two future landmarks)."""
        ids = np.unique(np.asarray(ids))
        ids = ids[self.lm_uid[ids] >= 0]
        if len(ids) == 0:
            return
        self.lm_obs_count[ids] = 0
        self.lm_first_kf[ids] = -1
        self.lm_uid[ids] = -1
        self._lm_free_pending.extend(int(i) for i in ids)

    def add_landmarks(
        self,
        ids: np.ndarray,
        pos,
        desc_pm1,
        normal,
        octave,
        min_dist,
        max_dist,
        first_kf: int,
        valid_mask: np.ndarray | None = None,
    ):
        """Batch landmark insertion (ref MapPoint ctor src/MapPoint.cpp:7-15,
        plus the distance/normal invariants the reference lacked)."""
        ids = np.asarray(ids)
        self._lm_pos[ids] = np.asarray(pos, np.float32)
        self._lm_desc_pm1[ids] = np.asarray(desc_pm1, np.int8)
        self._lm_normal[ids] = np.asarray(normal, np.float32)
        self._lm_octave[ids] = np.asarray(octave, np.int32)
        self._lm_min_dist[ids] = np.asarray(min_dist, np.float32)
        self._lm_max_dist[ids] = np.asarray(max_dist, np.float32)
        v = np.ones(len(ids), bool) if valid_mask is None else np.asarray(valid_mask)
        self._lm_valid[ids] = v
        self.lm_first_kf[ids] = first_kf
        self._touch_rows(
            ids,
            "lm_pos", "lm_desc_pm1", "lm_normal", "lm_octave",
            "lm_min_dist", "lm_max_dist", "lm_valid",
        )

    def set_landmark_positions(self, ids, pos):
        self._lm_pos[np.asarray(ids)] = np.asarray(pos, np.float32)
        self._touch_rows(ids, "lm_pos")

    def write_landmark_invariants(
        self, ids, normal, min_dist, max_dist, desc_pm1, octave, upd
    ):
        """Refresh invariants for the given landmark slots (host write; the
        jitted refresh kernel's outputs land here). `upd` masks rows with no
        observations (kept unchanged)."""
        ids = np.asarray(ids)[np.asarray(upd)]
        if len(ids) == 0:
            return
        sel = np.asarray(upd)
        self._lm_normal[ids] = np.asarray(normal, np.float32)[sel]
        self._lm_min_dist[ids] = np.asarray(min_dist, np.float32)[sel]
        self._lm_max_dist[ids] = np.asarray(max_dist, np.float32)[sel]
        self._lm_desc_pm1[ids] = np.asarray(desc_pm1, np.int8)[sel]
        self._lm_octave[ids] = np.asarray(octave, np.int32)[sel]
        self._touch_rows(
            ids,
            "lm_normal", "lm_min_dist", "lm_max_dist", "lm_desc_pm1", "lm_octave",
        )

    def erase_landmarks(self, ids: np.ndarray):
        """SetBadFlag semantics (absent in reference — SURVEY.md §2.1 #6).
        Slots are recycled (quarantined until the next keyframe)."""
        if len(ids) == 0:
            return
        ids = np.asarray(ids)
        self._lm_valid[ids] = False
        # remove from keyframe observation tables (host full-table op)
        is_bad = np.zeros(self.l_max, bool)
        is_bad[ids] = True
        obs_bad = (self._kf_obs >= 0) & is_bad[np.maximum(self._kf_obs, 0)]
        self._kf_obs[obs_bad] = -1
        self._covis_erase_landmarks(ids)
        self._free_landmark_slots(ids)
        self._touch_rows(ids, "lm_valid")
        self._touch("kf_obs")

    def evict_landmarks(self, n: int, protect: np.ndarray | None = None) -> int:
        """Pressure-driven landmark eviction for the fixed-shape table
        (KF slots already recycle via evict_keyframe; landmark slots only
        recycled passively until now — the 500-frame KITTI run saturated
        l_max and creation starved, VERDICT r3 next #2 regime). Erases the
        n lowest-VALUE valid landmarks: fewest observations first, then
        worst found/visible ratio (ORB-SLAM's culling signals). Protected
        ids (the live working set) are never evicted. Returns count."""
        if n <= 0:
            return 0
        valid = self._lm_valid[: self.n_lm].copy()
        if protect is not None and len(protect):
            p = np.asarray(protect, np.int64)
            valid[np.clip(p, 0, self.n_lm - 1)] = False
        cand = np.nonzero(valid)[0]
        if len(cand) == 0:
            return 0
        found_ratio = self.lm_found_count[cand] / np.maximum(
            self.lm_visible_count[cand], 1
        )
        order = np.lexsort((found_ratio, self.lm_obs_count[cand]))
        victims = cand[order[:n]]
        self.erase_landmarks(victims.astype(np.int32))
        return len(victims)

    def _gc_orphan_landmarks(self, candidate_ids: np.ndarray):
        """Free landmarks whose observation count dropped to zero (nothing
        references them anymore — keeping them would leak slots forever)."""
        if len(candidate_ids) == 0:
            return
        cand = np.unique(np.asarray(candidate_ids))
        orphan = cand[(self.lm_obs_count[cand] <= 0) & self._lm_valid[cand]]
        if len(orphan) == 0:
            return
        self._lm_valid[orphan] = False
        self._free_landmark_slots(orphan)
        self._touch_rows(orphan, "lm_valid")

    def add_observations(self, kf_id: int, feat_idx: np.ndarray, lm_ids: np.ndarray):
        """Bind landmark ids to keyframe features (MapPoint::AddObservation +
        KeyFrame::AddMapPoint semantics, src/MapPoint.cpp:17-24)."""
        if len(feat_idx) == 0:
            return
        self._kf_obs[kf_id, np.asarray(feat_idx)] = np.asarray(lm_ids, np.int32)
        np.add.at(self.lm_obs_count, np.asarray(lm_ids), 1)
        self._covis_add(kf_id, np.asarray(lm_ids))
        self._touch("kf_obs")

    # ---------------- queries ----------------

    def covisibility(self) -> np.ndarray:
        """(n_kf, n_kf) shared-landmark counts — maintained INCREMENTALLY
        under observation deltas (VERDICT r4 next #2: the full
        (n_kf, l_max) sgemm rebuild on every invalidation cost a mean
        14.9 ms x 1964 calls with 704 ms spikes in the KITTI-500 run).
        Every mutation path (add_keyframe, add_observations, scrub,
        erase, replace, remove_keyframe) applies its closed-form delta to
        `_covis`/`_sees`; the sgemm rebuild runs only after wholesale
        host-truth replacement (checkpoint load, test setters). The
        reference keeps per-KF weight maps incremental by the same logic
        (src/KeyFrame.cpp:54-116). Returned array is a live view —
        callers must not mutate it (copy before sorting in place)."""
        if self._covis_dirty:
            self._covis_rebuild()
        return self._covis[: self.n_kf, : self.n_kf]

    def keyframe_landmarks(self, kf_id: int) -> np.ndarray:
        """Landmark ids observed by a keyframe (host, deduped, valid only)."""
        obs = self._kf_obs[kf_id]
        ids = obs[obs >= 0]
        return np.unique(ids[self._lm_valid[ids]])

    def observations_of(self, lm_ids: np.ndarray) -> tuple:
        """(kf_idx, feat_idx, lm_idx_into_input) for all observations of the
        given landmarks across valid keyframes (host-side)."""
        obs = self._kf_obs[: self.n_kf]  # (K, F)
        lookup = np.full(self.l_max, -1, np.int64)
        lookup[lm_ids] = np.arange(len(lm_ids))
        hit = (obs >= 0) & (lookup[np.maximum(obs, 0)] >= 0)
        kf_idx, feat_idx = np.nonzero(hit)
        return kf_idx, feat_idx, lookup[obs[kf_idx, feat_idx]]

    def stats(self) -> dict:
        return {
            "n_kf": self.n_kf_active(),
            "n_lm": self.n_lm_active(),
            "n_obs": int((self._kf_obs >= 0).sum()),
            "kf_slots_hw": self.n_kf,
            "lm_slots_hw": self.n_lm,
            "kf_free": len(self._kf_free),
            "lm_free": len(self._lm_free) + len(self._lm_free_pending),
        }

    def remove_keyframe(self, kf_id: int):
        """KeyFrame::SetBadFlag semantics (absent in reference — SURVEY.md
        §2.1 #5 'SetBadFlag/culling absent'): drop the KF and its
        observations; landmark bookkeeping updated, the slot recycled, and
        landmarks anchored to this KF re-anchored to another observer.

        `on_kf_removed(kf_id, seq, pose)` fires first (if registered) so
        owners of keyframe-relative state — the tracker's anchored
        trajectory — can re-anchor before the slot is recycled. Without it,
        frames anchored to an evicted keyframe freeze at stale absolute
        poses and a later loop-closure correction leaves them in the OLD
        frame of reference (measured: running ATE *rose* through the orbit
        closure, round-4 probe)."""
        hook = getattr(self, "on_kf_removed", None)
        if hook is not None:
            hook(int(kf_id), int(self.kf_seq[kf_id]), self._kf_pose[kf_id].copy())
        obs = self._kf_obs[kf_id]
        seen = obs[obs >= 0]
        np.subtract.at(self.lm_obs_count, seen, 1)
        self._kf_valid[kf_id] = False
        self._kf_obs[kf_id] = -1
        self._kf_feat_valid[kf_id] = False
        self._kf_gdesc[kf_id] = 0.0
        self.kf_seq[kf_id] = -1
        self.kf_frame_id[kf_id] = -1
        self._kf_free.append(int(kf_id))
        self._touch("kf_valid", "kf_obs")
        self._touch_row("kf_feat_valid", kf_id)
        self._touch_row("kf_gdesc", kf_id)
        self._covis_remove_keyframe(kf_id)
        # re-anchor landmarks whose reference keyframe this was (loop closure
        # corrects landmarks through lm_first_kf — a dangling anchor would
        # move them with an unrelated pose after slot reuse)
        seen = np.unique(seen)
        anchored = seen[self.lm_first_kf[seen] == kf_id]
        if len(anchored):
            first = np.full(len(anchored), -1, np.int32)
            kf_idx, _, which = self.observations_of(anchored)
            if len(kf_idx):
                # earliest-seq observer becomes the new anchor: sort by seq
                # DESCENDING so duplicate fancy-index writes leave the
                # smallest seq in place (last write wins)
                order = np.argsort(-self.kf_seq[kf_idx], kind="stable")
                first[which[order]] = kf_idx[order].astype(np.int32)
            self.lm_first_kf[anchored] = first
        # landmarks that lost their last observation are garbage
        self._gc_orphan_landmarks(seen)

    def evict_keyframe(self, protect: np.ndarray) -> int:
        """Evict one keyframe to make room when the table is full: the most
        REDUNDANT one — the keyframe whose landmarks are best covered by
        other keyframes (ORB-SLAM's culling criterion applied to eviction).
        Returns the evicted slot or -1. Protect should contain the current
        local window (and is always honored).

        Why not weakest-connected-oldest: on a loop trajectory the old
        keyframes on the far side are exactly the ones with zero connection
        to the current working set, so that policy deletes the loop anchors
        place recognition needs; a unique-coverage (low-redundancy) keyframe
        is kept no matter how old or isolated it is."""
        valid = self._kf_valid[: self.n_kf].copy()
        protect = set(int(p) for p in protect)
        cands = [k for k in np.nonzero(valid)[0] if int(k) not in protect]
        if not cands:
            return -1
        obs = self._kf_obs
        # vectorized over candidates (VERDICT r3 weak #8: the per-candidate
        # Python scan). A keyframe with no landmark observations retains
        # nothing: maximally evictable (2.0, above any real score).
        # >= 4 = this KF's own observation + at least 3 OTHERS, matching
        # the KeyFrameCulling criterion the docstring cites.
        cand_arr = np.asarray(cands)
        obs_c = obs[cand_arr]  # (C, F)
        has = obs_c >= 0
        well = (self.lm_obs_count[np.maximum(obs_c, 0)] >= 4) & has
        n_has = has.sum(axis=1)
        redundancy = np.where(
            n_has > 0, well.sum(axis=1) / np.maximum(n_has, 1), 2.0
        )
        covis = self.covisibility()
        prot = [p for p in protect if p < self.n_kf and valid[p]]
        strength = (
            covis[np.asarray(cands)][:, np.asarray(prot, int)].sum(axis=1)
            if prot
            else np.zeros(len(cands))
        )
        # most redundant first; among equals, the one best represented by
        # the current working set
        order = sorted(
            range(len(cands)), key=lambda i: (-redundancy[i], -strength[i])
        )
        victim = int(cands[order[0]])
        self.remove_keyframe(victim)
        return victim

    def replace_landmark(self, loser: int, winner: int):
        """MapPoint::Replace semantics: merge duplicate landmarks after
        fusion; every observation of `loser` re-points to `winner` unless the
        keyframe already observes `winner` (then the duplicate is dropped).
        Vectorized host table ops."""
        obs = self._kf_obs
        kf_idx, feat_idx = np.nonzero(obs == loser)
        if len(kf_idx):
            sees_winner = (obs == winner).any(axis=1)
            drop = sees_winner[kf_idx]
            obs[kf_idx, feat_idx] = np.where(drop, -1, winner).astype(np.int32)
            self.lm_obs_count[winner] += int((~drop).sum())
            self._touch("kf_obs")
        self._covis_replace_landmark(loser, winner)
        self._lm_valid[loser] = False
        self._touch_rows([loser], "lm_valid")
        self._free_landmark_slots(np.asarray([loser]))

    def scrub_observations(self, kf_idx, feat_idx):
        """Remove specific (keyframe, feature) observations (BA outlier
        scrubbing); keeps the covisibility cache coherent and collects
        landmarks that lost their last observation."""
        if len(kf_idx) == 0:
            return
        kf_idx = np.asarray(kf_idx)
        feat_idx = np.asarray(feat_idx)
        obs = self._kf_obs[kf_idx, feat_idx]
        sel = obs >= 0
        seen = obs[sel]
        np.subtract.at(self.lm_obs_count, seen, 1)
        self._kf_obs[kf_idx, feat_idx] = -1
        self._covis_scrub(kf_idx[sel], seen)
        self._touch("kf_obs")
        self._gc_orphan_landmarks(seen)

    def pseudo_frame(self, kf_id: int):
        """View a stored keyframe as a Frame (for projection-based matching
        against keyframes — fusion, loop closing)."""
        from orbslam_in_practice.frontend.frame import Frame

        return Frame(
            xy=self.kf_xy[kf_id],
            xy_raw=self.kf_xy[kf_id],
            octave=self.kf_octave[kf_id],
            angle=self.kf_angle[kf_id],
            response=jnp.zeros(self.f_max, jnp.float32),
            valid=self.kf_feat_valid[kf_id],
            desc_packed=jnp.zeros((self.f_max, 8), jnp.uint32),
            desc_pm1=self.kf_desc_pm1[kf_id],
        )


def _make_mirror_property(name: str):
    def getter(self):
        return self._mirror(name)

    def setter(self, value):
        # external assignment (tests, checkpoint load): host truth replaced.
        # np.array COPIES — np.asarray of a jnp array yields a read-only
        # view that would poison later host mutations.
        setattr(self, "_" + name, np.array(value))
        self._dirty.add(name)
        if name in ("kf_obs", "kf_valid"):
            self._invalidate_caches()

    return property(getter, setter)


for _name in _MIRRORED:
    setattr(SlamMap, _name, _make_mirror_property(_name))
