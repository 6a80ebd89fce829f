"""Offline map / trajectory / frame viewer.

The reference's viewer is declared-absent scope (SURVEY.md §0: original
ORB-SLAM ships a Pangolin MapDrawer/FrameDrawer; the practice repo has
none). This engine runs headless, so the equivalent capability is an
offline renderer: top-down + profile map views with the camera trajectory,
and per-frame keypoint/match overlays. Pure host-side matplotlib (Agg) —
never on the device path.
"""

from __future__ import annotations

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def render_map(slam_map, path: str, trajectory=None, title: str | None = None):
    """Render landmarks + keyframe/camera trajectory to a PNG.

    slam_map: SlamMap. trajectory: optional (T, 3) camera centers (e.g.
    SlamSystem.get_trajectory()[:, 1:4]); keyframe centers are drawn always.
    """
    plt = _plt()
    lm = np.asarray(slam_map.lm_pos)[np.asarray(slam_map.lm_valid)]
    kf_pose = np.asarray(slam_map.kf_pose)[np.asarray(slam_map.kf_valid)]
    # camera center C = -R^T t for world->camera poses
    if len(kf_pose):
        centers = -np.einsum("kji,kj->ki", kf_pose[:, :3, :3], kf_pose[:, :3, 3])
    else:
        centers = np.zeros((0, 3))

    # robust display bounds: a single far triangulation outlier must not
    # collapse the whole map into one pixel
    ref_pts = [p for p in (centers, np.asarray(trajectory) if trajectory is not None else None) if p is not None and len(p)]
    anchor = np.concatenate(ref_pts, axis=0) if ref_pts else lm
    lims = None
    if len(anchor):
        lo = np.percentile(anchor, 2, axis=0)
        hi = np.percentile(anchor, 98, axis=0)
        span = np.maximum(hi - lo, 1e-3)
        lo, hi = lo - 1.5 * span - 1.0, hi + 1.5 * span + 1.0
        lims = (lo, hi)

    fig, axes = plt.subplots(1, 2, figsize=(12, 6))
    views = [("x", "z", 0, 2, "top-down (x-z)"), ("x", "y", 0, 1, "profile (x-y)")]
    for ax, (_, _, i, j, name) in zip(axes, views):
        if len(lm):
            keep = np.ones(len(lm), bool)
            if lims is not None:
                keep = np.all((lm >= lims[0]) & (lm <= lims[1]), axis=1)
            shown = lm[keep]
            ax.scatter(
                shown[:, i], shown[:, j], s=1.0, c="#9aa0a6",
                label=f"{len(shown)}/{len(lm)} landmarks",
            )
        if trajectory is not None and len(trajectory):
            tr = np.asarray(trajectory)
            ax.plot(tr[:, i], tr[:, j], "-", color="#1a73e8", lw=1.0, label="trajectory")
        if len(centers):
            ax.plot(centers[:, i], centers[:, j], "o", color="#d93025", ms=3.0, label=f"{len(centers)} keyframes")
        if lims is not None:
            ax.set_xlim(lims[0][i], lims[1][i])
            ax.set_ylim(lims[0][j], lims[1][j])
        ax.set_xlabel(name.split()[1][1])
        ax.set_title(name)
        ax.set_aspect("equal", adjustable="datalim")
        ax.legend(loc="best", fontsize=8)
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def render_frame(image, frame, path: str, matches=None, title: str | None = None):
    """Keypoint overlay for one frame (FrameDrawer role).

    image: (H, W) grayscale. frame: Frame (xy, valid, octave). matches:
    optional bool mask over features (drawn green vs gray).
    """
    plt = _plt()
    img = np.asarray(image)
    xy = np.asarray(frame.xy)
    valid = np.asarray(frame.valid)
    fig, ax = plt.subplots(figsize=(img.shape[1] / 100, img.shape[0] / 100), dpi=100)
    ax.imshow(img, cmap="gray", vmin=0, vmax=255)
    sel = valid
    if matches is not None:
        m = np.asarray(matches) & valid
        ax.plot(xy[sel & ~m, 0], xy[sel & ~m, 1], ".", color="#9aa0a6", ms=2)
        ax.plot(xy[m, 0], xy[m, 1], ".", color="#34a853", ms=3)
    else:
        ax.plot(xy[sel, 0], xy[sel, 1], ".", color="#34a853", ms=2)
    ax.set_axis_off()
    if title:
        ax.set_title(title)
    fig.savefig(path, bbox_inches="tight", pad_inches=0)
    plt.close(fig)
    return path
