"""Synthetic rendered sequences with ground truth (SURVEY.md §4.2).

Renders a random 3D point cloud of textured square blobs through a moving
pinhole camera — enough corner structure for the ORB front-end, with exact
ground-truth trajectory for end-to-end ATE tests and benchmarks (no real
datasets are available in this environment; the loaders for TUM/KITTI/EuRoC
formats live in io/datasets.py).
"""

from __future__ import annotations

import numpy as np

from orbslam_in_practice.geometry import se3

import jax.numpy as jnp


def make_trajectory(
    n_frames: int,
    kind: str = "strafe",
    step: float = 0.04,
    orbit_step: float | None = None,
):
    """Ground-truth Tcw per frame. Kinds: strafe (lateral), forward (FOE
    motion after a sideways lead-in for parallax), orbit (circle that
    revisits its start — loop-closure regime), rotation (yaw-dominant),
    kitti (forward driving with smooth 90-degree turns — BASELINE config-3
    motion regime)."""
    if kind in ("kitti", "kitti_loop"):
        # Forward motion punctuated by smooth 90-degree yaw arcs
        # (KITTI-00-like blocks): heading integrates the yaw rate,
        # position integrates the heading. A small lateral sway rides on
        # top — monocular two-view init at the pure focus of expansion is
        # degenerate (zero parallax at the FOE; real mono ORB-SLAM also
        # waits for parallax there), and real driving has it anyway.
        #
        # kitti: ALTERNATING turn signs — an S-course that never revisits
        # (BASELINE config 3, no loop closure).
        # kitti_loop: all four turns the SAME sign — a closed rounded-
        # rectangle block circuit; after frame 4*(straight+turn_len) the
        # camera re-drives the start street with the same heading
        # (BASELINE config 4, the Sim3 loop-closure regime at production
        # budgets — VERDICT r4 next #3).
        straight, turn_len = 90, 36
        yaw_rate = np.zeros(n_frames, np.float64)
        period = straight + turn_len
        for s in range(n_frames // period + 1):
            a = s * period + straight
            b = min(a + turn_len, n_frames)
            if a < n_frames:
                sign = 1.0 if (kind == "kitti_loop" or s % 2 == 0) else -1.0
                yaw_rate[a:b] = sign * (np.pi / 2) / turn_len
        psi = np.concatenate([[0.0], np.cumsum(yaw_rate)])[:-1]
        dirs = np.stack([np.sin(psi), np.zeros_like(psi), np.cos(psi)], -1)
        perp = np.stack([np.cos(psi), np.zeros_like(psi), -np.sin(psi)], -1)
        sway = 0.08 * np.sin(np.arange(n_frames) * 0.22)
        pos = np.concatenate(
            [np.zeros((1, 3)), np.cumsum(step * dirs, axis=0)[:-1]]
        )
        pos = pos + sway[:, None] * perp
        pos[:, 1] = 0.015 * np.sin(np.arange(n_frames) * 0.13)  # road bumps
        poses = []
        for i in range(n_frames):
            T = np.eye(4, dtype=np.float32)
            R_wc = np.asarray(
                se3.exp_so3(
                    jnp.asarray([0.0, float(psi[i]), 0.0], dtype=jnp.float32)
                )
            )
            T[:3, :3] = R_wc.T
            T[:3, 3] = -R_wc.T @ pos[i].astype(np.float32)
            poses.append(T)
        return np.stack(poses)
    poses = []
    for i in range(n_frames):
        T = np.eye(4, dtype=np.float32)
        if kind == "strafe":
            t_wc = np.array([i * step, 0.02 * np.sin(i * 0.2), 0.0])
            yaw = 0.01 * np.sin(i * 0.15)
        elif kind == "forward":
            t_wc = np.array([0.15 * np.sin(i * 0.08), 0.0, i * step])
            yaw = 0.02 * np.sin(i * 0.1)
        elif kind == "orbit":
            # circle of radius 3 centered at (0, 0, 3), camera facing
            # OUTWARD: the annulus wall (see SyntheticSequence) sits at
            # depth_range in front of every heading, and the start pose is
            # revisited after a full turn (loop-closure regime)
            ang = i * (orbit_step if orbit_step is not None else step * 0.2)
            t_wc = np.array([3.0 * np.sin(ang), 0.0, 3.0 * (1 - np.cos(ang))])
            yaw = np.pi - ang
        elif kind == "rotation":
            # rotation-dominant: slow lateral drift + strong sinusoidal yaw
            t_wc = np.array([i * step * 0.5, 0.0, 0.0])
            yaw = 0.35 * np.sin(i * 0.08)
        else:
            raise ValueError(kind)
        R_wc = np.asarray(
            se3.exp_so3(jnp.asarray([0.0, yaw, 0.0], dtype=jnp.float32))
        )
        # Tcw = inverse of [R_wc | t_wc]
        T[:3, :3] = R_wc.T
        T[:3, 3] = -R_wc.T @ t_wc
        poses.append(T)
    return np.stack(poses)


def _separable_gaussian(img: np.ndarray, sigma: float) -> np.ndarray:
    """Small separable Gaussian via shifted-slice sums (no scipy)."""
    r = int(np.ceil(2.5 * sigma))
    x = np.arange(-r, r + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    pad = np.pad(img, ((r, r), (0, 0)), mode="edge")
    out = np.zeros_like(img)
    for i, w in enumerate(k):
        out += w * pad[i : i + img.shape[0], :]
    pad = np.pad(out, ((0, 0), (r, r)), mode="edge")
    out2 = np.zeros_like(img)
    for i, w in enumerate(k):
        out2 += w * pad[:, i : i + img.shape[1]]
    return out2


class SyntheticSequence:
    """Renderable scene: world points with intensity/size attributes."""

    def __init__(
        self,
        n_frames: int = 60,
        n_points: int = 600,
        width: int = 640,
        height: int = 480,
        fx: float = 500.0,
        fy: float = 500.0,
        kind: str = "strafe",
        seed: int = 0,
        depth_range: tuple = (3.0, 9.0),
        spread: tuple = (6.0, 4.5),
        orbit_step: float | None = None,
        step: float = 0.04,
        noise_sigma: float = 0.0,
        brightness_jitter: float = 0.0,
        texture: float = 0.45,
        psf_sigma: float = 0.8,
        size_range: tuple = (0.06, 0.30),
        dist: tuple = (0.0, 0.0, 0.0, 0.0, 0.0),
    ):
        rng = np.random.default_rng(seed)
        self.width, self.height = width, height
        self.seed = seed
        self.noise_sigma = noise_sigma
        self.brightness_jitter = brightness_jitter
        self.psf_sigma = psf_sigma
        # radial-tangential lens distortion (k1, k2, p1, p2, k3): the ideal
        # pinhole render is warped through the lens model so the SLAM
        # front-end's in-graph undistortion runs ON the hot path (VERDICT r2
        # missing #3: every e2e previously ran pinhole-perfect). Inverse
        # mapping: for each DISTORTED output pixel, the ideal source pixel
        # comes from the same fixed-point iteration cv::undistortPoints /
        # geometry.camera.undistort_points use (ref src/Frame.cpp:80-109).
        self.dist = tuple(float(d) for d in dist)
        self._warp = None
        if any(abs(d) > 1e-12 for d in self.dist):
            cx_, cy_ = width / 2.0, height / 2.0
            us, vs = np.meshgrid(
                np.arange(width, dtype=np.float32),
                np.arange(height, dtype=np.float32),
            )
            x_d = (us - cx_) / fx
            y_d = (vs - cy_) / fy
            k1, k2, p1, p2, k3 = self.dist
            x, y = x_d.copy(), y_d.copy()
            for _ in range(10):
                r2 = x * x + y * y
                radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
                dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
                dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
                x = (x_d - dx) / radial
                y = (y_d - dy) / radial
            self._warp = (fx * x + cx_, fy * y + cy_)
        # per-blob painted texture amplitude. Flat uniform blobs are
        # adversarial for BRIEF: ~half the 256 point pairs then compare two
        # EQUAL-intensity pixels (zero margin), so any sensor noise makes
        # those bits coin flips (measured: Hamming ~75/256 between two
        # noisy renders of the SAME view). Real surfaces have texture;
        # a deterministic sinusoidal pattern painted on each blob restores
        # realistic nonzero BRIEF margins.
        self.texture = texture
        self.K = np.array(
            [[fx, 0, width / 2], [0, fy, height / 2], [0, 0, 1]], np.float32
        )
        self.poses = make_trajectory(
            n_frames, kind, step=step, orbit_step=orbit_step
        )
        self.n_frames = n_frames
        # scene sized to stay visible along the trajectory
        centers_w = np.stack(
            [-(T[:3, :3].T @ T[:3, 3]) for T in self.poses]
        )
        lo = centers_w.min(axis=0)
        hi = centers_w.max(axis=0)
        if kind == "orbit":
            # the orbit camera travels a circle of radius 3 centered at
            # (0, 0, 3) and always looks across it; a box scene leaves the
            # far side of the loop looking at a thin slab of points and
            # tracking starves. Sample an annulus wall around the circle so
            # every heading faces populated, roughly camera-facing surface.
            r_orb = 3.0
            phi = rng.uniform(0, 2 * np.pi, n_points)
            rad = r_orb + rng.uniform(depth_range[0], depth_range[1], n_points)
            yy = rng.uniform(-spread[1], spread[1], n_points)
            self.pts = np.stack(
                [rad * np.sin(phi), yy, r_orb - rad * np.cos(phi)],
                axis=-1,
            ).astype(np.float32)
        elif kind in ("kitti", "kitti_loop"):
            # corridor scene: facade quads lining both sides of the driven
            # path (building-wall statistics), sampled at random path
            # stations with lateral offsets in depth_range — every heading
            # along the straight/turn blocks faces populated structure,
            # like a street canyon does
            station = rng.integers(0, max(n_frames - 1, 1), n_points)
            d = centers_w[np.minimum(station + 1, n_frames - 1)] - centers_w[station]
            nrm = np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-6)
            d = d / nrm
            perp = np.stack([d[:, 2], np.zeros(n_points), -d[:, 0]], -1)
            side = np.where(rng.uniform(size=n_points) < 0.5, -1.0, 1.0)
            lat = rng.uniform(depth_range[0], depth_range[1], n_points)
            h = rng.uniform(-spread[1], spread[1], n_points)
            fwd = rng.uniform(0.0, 6.0, n_points)
            self.pts = (
                centers_w[station]
                + (side * lat)[:, None] * perp
                + d * fwd[:, None]
            ).astype(np.float32)
            self.pts[:, 1] = h
            # CORNER structure (VERDICT r3 missing #2 / round-3 diagnosis):
            # lateral facades alone leave the intersection diagonals empty —
            # mid-turn the camera faces the GAP between the two streets'
            # facade rows exactly when the old street leaves the FOV, and
            # tracking starves. Real intersections have the building across
            # the T-junction: for stations whose heading changes over the
            # next ~22 frames, respawn a fraction of quads AHEAD along the
            # mid-turn viewing direction (the "wall you drive toward").
            dirs_f = centers_w[1:] - centers_w[:-1]
            dirs_f = np.concatenate([dirs_f, dirs_f[-1:]], axis=0)
            dirs_f = dirs_f / np.maximum(
                np.linalg.norm(dirs_f, axis=-1, keepdims=True), 1e-6
            )
            look = 22
            ahead = np.minimum(np.arange(n_frames) + look, n_frames - 1)
            cos_turn = np.sum(dirs_f * dirs_f[ahead], axis=-1)
            turny = cos_turn < np.cos(0.25)  # >14 deg heading change coming
            # fraction 0.3: converting more was measured to DEPLETE the
            # second street's lateral facades (their stations are the turn
            # frames), starving extraction right after the turn
            frontal = turny[station] & (rng.uniform(size=n_points) < 0.3)
            if frontal.any():
                mid = dirs_f[station] + dirs_f[ahead[station]]
                mid = mid / np.maximum(
                    np.linalg.norm(mid, axis=-1, keepdims=True), 1e-6
                )
                dist = rng.uniform(
                    depth_range[0], depth_range[1], n_points
                )
                jit = rng.uniform(-3.0, 3.0, n_points)
                p_f = (
                    centers_w[station]
                    + mid * dist[:, None]
                    + np.stack(
                        [mid[:, 2], np.zeros(n_points), -mid[:, 0]], -1
                    )
                    * jit[:, None]
                )
                self.pts[frontal] = p_f[frontal].astype(np.float32)
                self.pts[:, 1] = h
            # PATH CLEARANCE: no quad may sit on the driven roadway. The
            # path is not straight, so a lateral facade of one street block
            # (or a junction quad) can land exactly where a LATER block
            # drives — measured: post-turn frames rendered with median
            # depth 1.4 m (quads filling the screen), starving extraction.
            # Push violating quads horizontally away from the nearest path
            # point to a street-width clearance.
            d2 = (
                (self.pts[:, None, [0, 2]] - centers_w[None, :, [0, 2]]) ** 2
            ).sum(-1)
            near = np.argmin(d2, axis=1)
            dmin = np.sqrt(d2[np.arange(n_points), near])
            clear = 4.0
            bad = dmin < clear
            if bad.any():
                c = centers_w[near[bad]]
                v = self.pts[bad] - c
                v[:, 1] = 0.0
                nv = np.linalg.norm(v, axis=1, keepdims=True)
                v = np.where(nv > 1e-6, v / np.maximum(nv, 1e-6), [[1.0, 0.0, 0.0]])
                pushed = c + v * (
                    clear + rng.uniform(1.0, 10.0, (int(bad.sum()), 1))
                )
                pushed[:, 1] = h[bad]
                self.pts[bad] = pushed.astype(np.float32)
            self._station = station
        else:
            self.pts = np.stack(
                [
                    rng.uniform(lo[0] - spread[0], hi[0] + spread[0], n_points),
                    rng.uniform(lo[1] - spread[1], hi[1] + spread[1], n_points),
                    rng.uniform(lo[2] + depth_range[0], hi[2] + depth_range[1], n_points),
                ],
                axis=-1,
            ).astype(np.float32)
        self.intensity = rng.uniform(90, 250, n_points).astype(np.float32)
        # quad half-extents in meters — large enough that a 31x31 BRIEF
        # patch at typical depth lands ON the textured surface, not on
        # flat background (tiny flat dots make ~half the BRIEF pairs
        # zero-margin -> coin flips under sensor noise). Scale size_range
        # with scene depth: under the optical PSF, texture below the pixel
        # resolution is (correctly) unresolvable, so far scenes need
        # bigger structure — like real ones do.
        self.size_m = rng.uniform(
            size_range[0], size_range[1], n_points
        ).astype(np.float32)
        self.background = 25.0
        # per-quad texture: spatial frequency (in quad-local units) + phase,
        # painted on the surface (world-anchored, rotation-consistent)
        self.tex_f = rng.uniform(2.0, 5.0, (n_points, 2)).astype(np.float32)
        self.tex_p = rng.uniform(0, 2 * np.pi, (n_points, 2)).astype(np.float32)
        # quad orientation: normal roughly facing the trajectory (so quads
        # are observable along the run) with a random tilt; in-plane axes
        # complete the frame. All world-anchored: a texture corner is a
        # genuine static 3D point, consistent under camera rotation.
        to_cam = centers_w.mean(axis=0)[None, :] - self.pts
        if kind in ("kitti", "kitti_loop"):
            # a corridor's mean center is meaningless at the path ends:
            # face each facade quad at the path station it was spawned from
            to_cam = centers_w[self._station] - self.pts
        to_cam = to_cam / np.maximum(
            np.linalg.norm(to_cam, axis=-1, keepdims=True), 1e-9
        )
        tilt = rng.normal(0.0, 0.25, (n_points, 3)).astype(np.float32)
        n = to_cam + tilt
        n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
        up = np.tile(np.array([0.0, 1.0, 0.0], np.float32), (n_points, 1))
        # avoid degenerate cross products when n ~ up
        swap = np.abs((n * up).sum(-1)) > 0.95
        up[swap] = np.array([1.0, 0.0, 0.0], np.float32)
        e1 = np.cross(up, n)
        e1 = e1 / np.maximum(np.linalg.norm(e1, axis=-1, keepdims=True), 1e-9)
        e2 = np.cross(n, e1)
        self.quad_n = n.astype(np.float32)
        self.quad_e1 = e1.astype(np.float32)
        self.quad_e2 = e2.astype(np.float32)

    def gt_centers(self) -> np.ndarray:
        """(T, 3) ground-truth camera centers (world)."""
        return np.stack([-(T[:3, :3].T @ T[:3, 3]) for T in self.poses])

    def backproject(self, i: int, xy: np.ndarray) -> tuple:
        """Exact ground-truth 3D world points for pixel coordinates in frame
        i: ray-cast each pixel against the rendered depth buffer. Returns
        (points_w (N,3), valid (N,)) — invalid where the pixel hits
        background or straddles a depth discontinuity (quad boundary)."""
        _, zbuf = self.render(i, return_depth=True)
        T = self.poses[i]
        xy = np.asarray(xy, np.float32)
        xi = np.clip(np.round(xy[:, 0]).astype(np.int64), 0, self.width - 1)
        yi = np.clip(np.round(xy[:, 1]).astype(np.int64), 0, self.height - 1)
        # depth-consistency gate: 3x3 neighborhood must be one surface
        zpad = np.pad(zbuf, 1, constant_values=np.inf)
        neigh = np.stack(
            [
                zpad[yi + dy, xi + dx]
                for dy in (0, 1, 2)
                for dx in (0, 1, 2)
            ]
        )
        z = zbuf[yi, xi]
        finite = np.isfinite(neigh).all(axis=0)
        spread_ok = np.zeros(len(xy), bool)
        if finite.any():
            nf = neigh[:, finite]
            spread_ok[finite] = (nf.max(axis=0) - nf.min(axis=0)) < (
                0.02 * np.maximum(z[finite], 1e-6)
            )
        flat = finite & spread_ok
        valid = np.isfinite(z) & flat
        zs = np.where(valid, z, 1.0)
        xn = (xy[:, 0] - self.K[0, 2]) / self.K[0, 0]
        yn = (xy[:, 1] - self.K[1, 2]) / self.K[1, 1]
        if self._warp is not None:
            # query pixels are DISTORTED image coords (the z lookup above is
            # right: the warped depth buffer is in distorted pixel space),
            # but the ray direction needs the UNDISTORTED normalized coords
            k1, k2, p1, p2, k3 = self.dist
            x, y = xn.copy(), yn.copy()
            for _ in range(10):
                r2 = x * x + y * y
                radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
                dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
                dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
                x = (xn - dx) / radial
                y = (yn - dy) / radial
            xn, yn = x, y
        rays = np.stack(
            [xn, yn, np.ones(len(xy), np.float32)],
            axis=-1,
        )
        X_c = rays * zs[:, None]
        X_w = (X_c - T[:3, 3]) @ T[:3, :3]
        return X_w.astype(np.float32), valid

    def render(self, i: int, return_depth: bool = False):
        """(H, W) float32 grayscale frame i.

        Z-buffered rasterization of world-anchored textured planar quads:
        for each quad, pixels in its projected bounding box are ray-cast
        against the quad's plane and shaded with a sinusoidal texture in
        quad-local coordinates. Every texture feature is therefore a real
        static 3D point — geometrically consistent under arbitrary camera
        rotation (unlike image-axis-aligned billboards)."""
        T = self.poses[i]
        R, t = T[:3, :3], T[:3, 3]
        P_c = self.pts @ R.T + t  # quad centers, camera frame
        n_c = self.quad_n @ R.T
        e1_c = self.quad_e1 @ R.T
        e2_c = self.quad_e2 @ R.T
        fx, fy = self.K[0, 0], self.K[1, 1]
        cx, cy = self.K[0, 2], self.K[1, 2]
        img = np.full((self.height, self.width), self.background, np.float32)
        zbuf = np.full((self.height, self.width), np.inf, np.float32)
        # 4 corners of each quad in camera frame: (N, 4, 3)
        s = self.size_m[:, None]
        corners = (
            P_c[:, None, :]
            + np.stack(
                [
                    s * e1_c + s * e2_c,
                    s * e1_c - s * e2_c,
                    -s * e1_c + s * e2_c,
                    -s * e1_c - s * e2_c,
                ],
                axis=1,
            )
        )
        cz = corners[..., 2]
        vis = cz.max(axis=1) > 0.3  # at least one corner in front
        uc = fx * corners[..., 0] / np.maximum(cz, 0.1) + cx
        vc = fy * corners[..., 1] / np.maximum(cz, 0.1) + cy
        for j in np.nonzero(vis)[0]:
            if cz[j].min() <= 0.3:
                continue  # quad straddles the near plane; skip (rare)
            x0 = max(int(np.floor(uc[j].min())), 0)
            x1 = min(int(np.ceil(uc[j].max())) + 1, self.width)
            y0 = max(int(np.floor(vc[j].min())), 0)
            y1 = min(int(np.ceil(vc[j].max())) + 1, self.height)
            if x0 >= x1 or y0 >= y1:
                continue
            rx = (np.arange(x0, x1, dtype=np.float32) - cx) / fx
            ry = (np.arange(y0, y1, dtype=np.float32) - cy) / fy
            # ray (rx, ry, 1) . n  and plane offset P.n -> depth along ray
            denom = rx[None, :] * n_c[j, 0] + ry[:, None] * n_c[j, 1] + n_c[j, 2]
            pn = float(P_c[j] @ n_c[j])
            with np.errstate(divide="ignore", invalid="ignore"):
                tz = pn / denom  # hit depth (z of intersection)
            Xx = tz * rx[None, :] - P_c[j, 0]
            Xy = tz * ry[:, None] - P_c[j, 1]
            Xz = tz - P_c[j, 2]
            a = (Xx * e1_c[j, 0] + Xy * e1_c[j, 1] + Xz * e1_c[j, 2]) / self.size_m[j]
            b = (Xx * e2_c[j, 0] + Xy * e2_c[j, 1] + Xz * e2_c[j, 2]) / self.size_m[j]
            zwin = zbuf[y0:y1, x0:x1]
            hit = (
                (np.abs(a) <= 1.0)
                & (np.abs(b) <= 1.0)
                & (tz > 0.3)
                & (tz < zwin)
                & np.isfinite(tz)
            )
            if not hit.any():
                continue
            if self.texture > 0.0:
                pat = np.sin(
                    self.tex_f[j, 0] * a * np.pi + self.tex_p[j, 0]
                ) * np.sin(self.tex_f[j, 1] * b * np.pi + self.tex_p[j, 1])
                shade = self.intensity[j] * (
                    1.0 - self.texture * (0.5 + 0.5 * pat)
                )
            else:
                shade = np.full(hit.shape, self.intensity[j], np.float32)
            win = img[y0:y1, x0:x1]
            win[hit] = shade[hit] if self.texture > 0.0 else self.intensity[j]
            zwin[hit] = tz[hit]
        # lens distortion: warp the ideal pinhole image into the observed
        # (distorted) image by bilinear inverse mapping. Done before the PSF
        # (the lens bends rays; the PSF blurs at the sensor).
        if self._warp is not None:
            su, sv = self._warp
            x0 = np.clip(np.floor(su).astype(np.int64), 0, self.width - 2)
            y0 = np.clip(np.floor(sv).astype(np.int64), 0, self.height - 2)
            fu = np.clip(su - x0, 0.0, 1.0).astype(np.float32)
            fv = np.clip(sv - y0, 0.0, 1.0).astype(np.float32)
            inside = (
                (su >= 0) & (su <= self.width - 1)
                & (sv >= 0) & (sv <= self.height - 1)
            )
            warped = (
                img[y0, x0] * (1 - fu) * (1 - fv)
                + img[y0, x0 + 1] * fu * (1 - fv)
                + img[y0 + 1, x0] * (1 - fu) * fv
                + img[y0 + 1, x0 + 1] * fu * fv
            )
            img = np.where(inside, warped, self.background).astype(np.float32)
            if return_depth:
                # nearest-neighbor warp of the depth buffer keeps
                # backproject() consistent with the distorted image
                xi = np.clip(np.round(su).astype(np.int64), 0, self.width - 1)
                yi = np.clip(np.round(sv).astype(np.int64), 0, self.height - 1)
                zbuf = np.where(inside, zbuf[yi, xi], np.inf).astype(np.float32)
        # optical PSF: real images are band-limited by the lens before the
        # sensor samples them. Point-sampled sinusoidal texture aliases, so
        # descriptors would otherwise flicker under subpixel motion.
        if self.psf_sigma > 0.0:
            img = _separable_gaussian(img, self.psf_sigma)
        if self.brightness_jitter > 0.0 or self.noise_sigma > 0.0:
            # deterministic per-frame degradation (real-data-shaped: sensor
            # noise + exposure changes; VERDICT round 1 item 7)
            frng = np.random.default_rng((self.seed + 1) * 100003 + i)
            if self.brightness_jitter > 0.0:
                gain = 1.0 + self.brightness_jitter * float(
                    frng.uniform(-1.0, 1.0)
                )
                img = img * gain
            if self.noise_sigma > 0.0:
                img = img + frng.normal(
                    0.0, self.noise_sigma, img.shape
                ).astype(np.float32)
            img = np.clip(img, 0.0, 255.0)
        if return_depth:
            return img, zbuf
        return img
