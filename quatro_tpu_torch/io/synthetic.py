"""Synthetic LiDAR scene generation with ground-truth transforms.

The reference's de-facto integration fixture is a KITTI scan pair downloaded
at configure time (reference: CMakeLists.txt:57-58) — unavailable offline.
This module replaces it with a procedural urban scene (ground plane + boxes +
poles) and a vectorized spinning-LiDAR ray-caster, so every test and benchmark
runs hermetically with exact ground truth:

* two sensor poses observing the same world -> two scans + the exact relative
  transform the solver must recover;
* scans exhibit the structure the pipeline depends on: a dominant ground
  plane (for Patchwork), vertical surfaces (for FPFH normals), range-image
  continuity (for projection clustering).

Everything here is plain numpy on the host: scene generation is IO, not
device compute. This is a copy of ``quatro_tpu/io/synthetic.py`` taking
the port's ``LidarConfig``; its outputs are bit-identical to the JAX
package's for the same arguments (tests/test_torch_frontend_prep.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from quatro_tpu_torch.config import LidarConfig

_FIXTURE_VERSION = 5  # v5: terrain + dynamic clutter (v4: clearance by
                      # resampling; v3's rim-push built courtyard walls
                      # around poses; v2/v1 let wide boxes swallow poses)


@dataclass(frozen=True)
class Terrain:
    """Smooth non-flat ground: z(x, y) = sx*x + sy*y + amp*sin*cos ripple.

    Sloped/curved terrain stresses Patchwork's per-ring elevation and
    flatness gates for real (reference: include/patchwork.hpp:394-451 —
    on a perfectly flat world those gates never fire). Sensors stay
    gravity-aligned (mounted level), so the ground-truth transform remains
    quasi-SO(3); combine with eval tilt_deg for non-level platforms.
    """

    slope_x: float = 0.0
    slope_y: float = 0.0
    amp: float = 0.0
    freq: float = 0.05  # rad/m of the sinusoidal ripple

    def height(self, x, y):
        base = self.slope_x * x + self.slope_y * y
        if self.amp:
            base = base + self.amp * np.sin(self.freq * x) * np.cos(
                0.83 * self.freq * y + 0.7)
        return base


@dataclass
class Scene:
    """Axis-aligned boxes on a ground surface, in world coordinates."""

    box_min: np.ndarray  # (M, 3)
    box_max: np.ndarray  # (M, 3)
    ground_z: float = 0.0
    terrain: Terrain | None = None  # None = flat plane at ground_z
    box_kind: np.ndarray | None = None  # (M,) 0=building 1=car 2=pole


def make_scene(seed: int = 0, num_buildings: int = 24, num_cars: int = 16,
               num_poles: int = 30, extent: float = 60.0,
               clear_points: Tuple[Tuple[float, float], ...] = ((0.0, 0.0),),
               clear_radius: float = 2.5,
               terrain: Terrain | None = None) -> Scene:
    """Random urban-ish scene: big boxes (buildings), small boxes (cars),
    thin tall boxes (poles/trunks).

    ``clear_points`` are xy positions (sensor poses) that must stay outside
    all box VOLUME by ``clear_radius``. The check uses the box's nearest
    point, not its center: a wide building whose center is far away can
    still swallow a sensor pose, which yields a scan of the box interior
    and a zero-overlap pair. Small per-pose discs (rather than one big
    clear zone) keep near-range structure, which sparse LiDARs (VLP-16)
    depend on.
    """
    rng = np.random.default_rng(seed)
    mins, maxs, kinds = [], [], []
    clear_pts = np.atleast_2d(np.asarray(clear_points, np.float64))

    def violates(cx, cy, sx, sy):
        dx = np.maximum(np.abs(cx - clear_pts[:, 0]) - sx / 2, 0.0)
        dy = np.maximum(np.abs(cy - clear_pts[:, 1]) - sy / 2, 0.0)
        return (np.hypot(dx, dy) < clear_radius).any()

    def add_box(draw_center, sx, sy, sz, kind):
        # resample the location until it clears every sensor disc (pushing
        # violators to the disc rim instead would pile boxes into an
        # enclosing "courtyard wall" around the pose); drop after 8 tries
        for _ in range(8):
            cx, cy = draw_center()
            if not violates(cx, cy, sx, sy):
                z0 = terrain.height(cx, cy) if terrain is not None else 0.0
                mins.append([cx - sx / 2, cy - sy / 2, z0])
                maxs.append([cx + sx / 2, cy + sy / 2, z0 + sz])
                kinds.append(kind)
                return

    for _ in range(num_buildings):
        add_box(lambda: rng.uniform(-extent, extent, 2),
                rng.uniform(4, 14), rng.uniform(4, 14), rng.uniform(3, 12),
                kind=0)
    for _ in range(num_cars):
        add_box(lambda: rng.uniform(-extent * 0.6, extent * 0.6, 2),
                rng.uniform(1.6, 2.2), rng.uniform(3.8, 5.0),
                rng.uniform(1.4, 1.9), kind=1)
    for _ in range(num_poles):
        add_box(lambda: rng.uniform(-extent * 0.8, extent * 0.8, 2),
                rng.uniform(0.25, 0.5), rng.uniform(0.25, 0.5),
                rng.uniform(3, 7), kind=2)

    return Scene(box_min=np.array(mins, dtype=np.float64).reshape(-1, 3),
                 box_max=np.array(maxs, dtype=np.float64).reshape(-1, 3),
                 terrain=terrain,
                 box_kind=np.array(kinds, dtype=np.int32))


def displace_cars(scene: Scene, fraction: float, seed: int,
                  max_shift: float = 8.0) -> Scene:
    """Dynamic clutter: move `fraction` of the car boxes to new nearby
    positions (and resize height slightly) — objects that changed between
    the two captures of a pair, like real traffic. Registration must
    succeed off the static structure; the moved cars contribute pure
    outlier correspondences."""
    if fraction <= 0.0 or scene.box_kind is None:
        return scene
    rng = np.random.default_rng(seed)
    cars = np.flatnonzero(scene.box_kind == 1)
    n_move = int(round(fraction * cars.size))
    if n_move == 0:
        return scene
    move = rng.choice(cars, size=n_move, replace=False)
    bmin = scene.box_min.copy()
    bmax = scene.box_max.copy()
    shift = rng.uniform(-max_shift, max_shift, (n_move, 2))
    # keep them at least 2 m displaced so they really are dynamic
    shift += np.sign(shift) * 2.0
    bmin[move, :2] += shift
    bmax[move, :2] += shift
    if scene.terrain is not None:
        cx = 0.5 * (bmin[move, 0] + bmax[move, 0])
        cy = 0.5 * (bmin[move, 1] + bmax[move, 1])
        h = scene.box_max[move, 2] - scene.box_min[move, 2]
        z0 = scene.terrain.height(cx, cy)
        bmin[move, 2] = z0
        bmax[move, 2] = z0 + h
    return Scene(box_min=bmin, box_max=bmax, ground_z=scene.ground_z,
                 terrain=scene.terrain, box_kind=scene.box_kind)


def _ray_box_hits(origins: np.ndarray, dirs: np.ndarray,
                  box_min: np.ndarray, box_max: np.ndarray) -> np.ndarray:
    """Slab-method ray/AABB intersection.

    origins (R,3), dirs (R,3), boxes (M,3) -> t (R, M), +inf where missed.
    """
    inv = 1.0 / np.where(np.abs(dirs) < 1e-12, 1e-12, dirs)
    t0 = (box_min[None, :, :] - origins[:, None, :]) * inv[:, None, :]
    t1 = (box_max[None, :, :] - origins[:, None, :]) * inv[:, None, :]
    tmin = np.minimum(t0, t1).max(axis=2)
    tmax = np.maximum(t0, t1).min(axis=2)
    hit = (tmax >= tmin) & (tmax > 1e-6)
    t = np.where(tmin > 1e-6, tmin, tmax)  # allow origin inside a box
    return np.where(hit, t, np.inf)


def raycast_scan(scene: Scene, sensor_xyz: np.ndarray, sensor_yaw: float,
                 lidar: LidarConfig = LidarConfig(), max_range: float = 80.0,
                 noise_std: float = 0.008, dropout: float = 0.05,
                 texture_amp: float = 0.06, seed: int = 0) -> np.ndarray:
    """Simulate one spinning-LiDAR scan; returns (N,3) points in SENSOR frame.

    The ray grid mirrors the reference's range-image geometry
    (reference: include/imageProjection.hpp:85-124,308-352): `n_scan`
    elevation rings spanning [-ang_bottom, -ang_bottom + fov] degrees,
    `horizon_scan` azimuth steps.
    """
    rng = np.random.default_rng(seed)
    n_rows, n_cols = lidar.n_scan, lidar.horizon_scan
    fov_up = -lidar.ang_bottom + lidar.ang_res_y * (n_rows - 1)
    elev = np.deg2rad(np.linspace(-lidar.ang_bottom, fov_up, n_rows))
    azim = np.linspace(0, 2 * np.pi, n_cols, endpoint=False) + sensor_yaw

    ce, se = np.cos(elev), np.sin(elev)
    ca, sa = np.cos(azim), np.sin(azim)
    # (rows, cols, 3) ray directions in world frame
    dirs = np.stack([ce[:, None] * ca[None, :],
                     ce[:, None] * sa[None, :],
                     np.broadcast_to(se[:, None], (n_rows, n_cols))], axis=-1)
    dirs = dirs.reshape(-1, 3)
    origins = np.broadcast_to(np.asarray(sensor_xyz, np.float64), dirs.shape)

    # Ground hit: flat plane, or fixed-point iteration against the terrain
    # height field (converges in a few steps for gentle slopes; rays that
    # fail to converge are treated as misses — they graze near-horizontally
    # and land beyond max_range anyway).
    dz = dirs[:, 2]
    safe_dz = np.where(dz == 0, 1, dz)
    if scene.terrain is None:
        t_ground = np.where(dz < -1e-9,
                            (scene.ground_z - origins[:, 2]) / safe_dz,
                            np.inf)
    else:
        descending = dz < -1e-3
        h0 = scene.ground_z + scene.terrain.height(origins[:, 0],
                                                   origins[:, 1])
        t_g = np.where(descending, (h0 - origins[:, 2]) / safe_dz, np.inf)
        t_g = np.clip(np.where(np.isfinite(t_g), t_g, 0.0), 0.0, max_range)
        for _ in range(12):
            x = origins[:, 0] + t_g * dirs[:, 0]
            y = origins[:, 1] + t_g * dirs[:, 1]
            h = scene.ground_z + scene.terrain.height(x, y)
            t_g = np.clip((h - origins[:, 2]) / safe_dz, 0.0, max_range)
        x = origins[:, 0] + t_g * dirs[:, 0]
        y = origins[:, 1] + t_g * dirs[:, 1]
        z = origins[:, 2] + t_g * dz
        h = scene.ground_z + scene.terrain.height(x, y)
        converged = descending & (np.abs(z - h) < 0.02) & (t_g > 0)
        t_ground = np.where(converged, t_g, np.inf)
    # Boxes — chunk over rays to bound memory.
    t_box = np.full(dirs.shape[0], np.inf)
    chunk = 16384
    for s in range(0, dirs.shape[0] if scene.box_min.size else 0, chunk):
        e = s + chunk
        t_box[s:e] = _ray_box_hits(origins[s:e], dirs[s:e],
                                   scene.box_min, scene.box_max).min(axis=1)

    t = np.minimum(t_ground, t_box)
    valid = np.isfinite(t) & (t > 0.5) & (t < max_range)
    if dropout > 0:
        valid &= rng.random(t.shape) > dropout
    t = t + rng.normal(0, noise_std, t.shape)  # range noise

    pts_world = origins[valid] + dirs[valid] * t[valid, None]
    if texture_amp > 0:
        # World-anchored surface texture: a smooth pseudorandom range
        # displacement that is a pure function of world position, so both
        # scans of a pair see CONSISTENT structure (like real facades /
        # vegetation). Perfectly flat synthetic walls would otherwise make
        # FPFH translation-degenerate along the surface.
        px, py, pz = pts_world.T
        bump = (np.sin(2.1 * px + 0.7) * np.sin(1.9 * py + 1.3)
                * np.sin(2.3 * pz + 0.5)
                + 0.5 * np.sin(4.3 * px - 1.1) * np.sin(3.7 * pz + 2.0))
        pts_world = pts_world + dirs[valid] * (texture_amp * bump)[:, None]
    # World -> sensor frame: p_s = Rz(yaw)^T (p_w - origin)
    c, s_ = np.cos(sensor_yaw), np.sin(sensor_yaw)
    rot_t = np.array([[c, s_, 0], [-s_, c, 0], [0, 0, 1]])
    pts = (pts_world - np.asarray(sensor_xyz)) @ rot_t.T
    return pts.astype(np.float32)


def make_scan_pair(seed: int = 0, yaw_deg: float = 25.0,
                   translation: Tuple[float, float, float] = (3.0, 1.5, 0.05),
                   sensor_height: float = 1.723,
                   lidar: LidarConfig = LidarConfig(),
                   cache_dir: str | None = None,
                   terrain: Terrain | None = None,
                   dynamic_fraction: float = 0.0,
                   **scan_kwargs):
    """Two scans of one world from two poses + the ground-truth transform.

    Returns (src_xyz, tgt_xyz, gt) with gt the 4x4 transform such that
    ``gt @ src ~= tgt`` (the solver's convention: dst = R*src + t,
    reference: include/quatro.hpp:597).

    Pose A is the *target* frame origin; pose B (displaced by `translation`
    and rotated by `yaw_deg`) produces the *source* scan.

    With `terrain`, the ground is sloped/curved and each sensor sits at
    terrain height + sensor_height over its own xy (still gravity-aligned,
    so gt stays quasi-SO(3) with the true z offset). With
    `dynamic_fraction` > 0, that share of the car boxes MOVES between the
    two captures (traffic) — pure outlier structure the pipeline must
    reject.
    """
    cache_path = None
    if cache_dir is not None:
        import hashlib
        import os
        os.makedirs(cache_dir, exist_ok=True)
        # _FIXTURE_VERSION salts the key: bump whenever scene/raycast
        # generation changes so stale cached pairs are regenerated.
        key = hashlib.sha1(repr((_FIXTURE_VERSION, seed, yaw_deg,
                                 tuple(translation),
                                 sensor_height, lidar, terrain,
                                 dynamic_fraction, sorted(
                                     scan_kwargs.items()))).encode()
                           ).hexdigest()[:16]
        cache_path = os.path.join(cache_dir, f"pair_{key}.npz")
        if os.path.exists(cache_path):
            z = np.load(cache_path)
            return z["src"], z["tgt"], z["gt"]

    yaw = np.deg2rad(yaw_deg)
    tr = np.asarray(translation, np.float64)
    ha = terrain.height(0.0, 0.0) if terrain is not None else 0.0
    hb = terrain.height(tr[0], tr[1]) if terrain is not None else 0.0
    t_a = np.array([0.0, 0.0, ha + sensor_height])
    t_b = np.array([tr[0], tr[1], hb + sensor_height + tr[2]])
    scene = make_scene(seed, clear_points=((t_a[0], t_a[1]),
                                           (t_b[0], t_b[1])),
                       terrain=terrain)
    scene_b = displace_cars(scene, dynamic_fraction, seed=seed + 31)

    tgt = raycast_scan(scene, t_a, 0.0, lidar=lidar, seed=seed + 1, **scan_kwargs)
    src = raycast_scan(scene_b, t_b, yaw, lidar=lidar, seed=seed + 2, **scan_kwargs)

    # src frame -> tgt frame: p_A = R_A^T R_B p_B + R_A^T (t_B - t_A);
    # with R_A = I, R_B = Rz(yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    gt = np.eye(4)
    gt[:3, :3] = rot
    gt[:3, 3] = t_b - t_a
    gt = gt.astype(np.float32)
    if cache_path is not None:
        np.savez_compressed(cache_path, src=src, tgt=tgt, gt=gt)
    return src, tgt, gt


def make_correspondences(seed: int = 0, n_inliers: int = 60,
                         n_outliers: int = 240, yaw_deg: float = 30.0,
                         translation: Tuple[float, float, float] = (2.0, -1.0, 0.3),
                         noise_std: float = 0.05, extent: float = 30.0,
                         roll_pitch: Tuple[float, float] = (0.0, 0.0)):
    """Correspondence-level fixture for solver unit/property tests.

    Returns (src (N,3), tgt (N,3), gt 4x4, inlier_mask (N,)) with
    tgt = R*src + t + noise for inliers and uniform junk for outliers —
    the >95%-outlier regime the solver is built for (reference: README.md:15).
    """
    rng = np.random.default_rng(seed)
    yaw = np.deg2rad(yaw_deg)
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    if roll_pitch != (0.0, 0.0):
        rl, pt = roll_pitch
        rx = np.array([[1, 0, 0], [0, np.cos(rl), -np.sin(rl)], [0, np.sin(rl), np.cos(rl)]])
        ry = np.array([[np.cos(pt), 0, np.sin(pt)], [0, 1, 0], [-np.sin(pt), 0, np.cos(pt)]])
        rot = rot @ ry @ rx
    t = np.asarray(translation, np.float64)

    src_in = rng.uniform(-extent, extent, (n_inliers, 3))
    src_in[:, 2] = rng.uniform(-2, 6, n_inliers)
    tgt_in = src_in @ rot.T + t + rng.normal(0, noise_std, (n_inliers, 3))

    src_out = rng.uniform(-extent, extent, (n_outliers, 3))
    tgt_out = rng.uniform(-extent, extent, (n_outliers, 3))

    src = np.concatenate([src_in, src_out]).astype(np.float32)
    tgt = np.concatenate([tgt_in, tgt_out]).astype(np.float32)
    mask = np.zeros(n_inliers + n_outliers, dtype=bool)
    mask[:n_inliers] = True

    # shuffle so inliers are not contiguous
    perm = rng.permutation(src.shape[0])
    gt = np.eye(4, dtype=np.float32)
    gt[:3, :3] = rot
    gt[:3, 3] = t
    return src[perm], tgt[perm], gt, mask[perm]
