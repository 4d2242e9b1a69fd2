"""KITTI calibration and poses, the semantic-kitti LaserScan projection
(ldm/lidar_utils.py) that feeds RangeNet++ on the metrics path, and the
reference's `save_generated` (a log-range image to a LiDARGen-geometry
.bin). Numpy on the host, as the reference computes it. The sampling CLIs
write their .bin files with `pipelines.pipeline.save_outputs`, through the
training sensor's own geometry.
"""

from __future__ import annotations

import numpy as np

from rangeldm_tpu_torch.geometry.projection import decode_log_range


def load_matrices(kitti_path: str, data_name: str):
    """velo->pose calibration chain + per-frame poses
    (ldm/lidar_utils.py:6-26)."""
    cam_to_velo = np.identity(4)
    cam_to_velo[0:3, :] = np.loadtxt(
        kitti_path + "/calibration/calib_cam_to_velo.txt",
        usecols=tuple(range(12))).reshape(3, 4)
    velo_to_cam = np.linalg.inv(cam_to_velo)

    cam_to_pose = np.identity(4)
    cam_to_pose[0:3, :] = np.loadtxt(
        kitti_path + "/calibration/calib_cam_to_pose.txt",
        usecols=tuple(range(1, 13)))[0].reshape(3, 4)

    poses_loaded = np.loadtxt(
        kitti_path + "/data_poses/" + data_name + "/poses.txt",
        usecols=tuple(range(1, 13))).reshape(-1, 3, 4)
    poses = np.repeat(np.identity(4)[None], poses_loaded.shape[0], axis=0)
    poses[:, 0:3, :] = poses_loaded
    return cam_to_pose @ velo_to_cam, poses


def laserscan_project(points: np.ndarray, remissions: np.ndarray = None,
                      h: int = 64, w: int = 1024,
                      fov_up_deg: float = 3.0, fov_down_deg: float = -25.0):
    """semantic-kitti LaserScan.do_range_projection
    (metrics/.../histogram.py:210-270; ldm/lidar_utils.py:52-215): floor
    binning, clamp, descending-depth ordering so the nearest point wins.
    Returns (proj_range, proj_xyz, proj_remission, proj_mask)."""
    if remissions is None:
        remissions = np.zeros(points.shape[0], np.float32)
    fov_up = fov_up_deg / 180.0 * np.pi
    fov_down = fov_down_deg / 180.0 * np.pi
    fov = abs(fov_down) + abs(fov_up)

    depth = np.linalg.norm(points, 2, axis=1)
    yaw = -np.arctan2(points[:, 1], points[:, 0])
    pitch = np.arcsin(points[:, 2] / np.maximum(depth, 1e-12))

    px = np.clip(np.floor(0.5 * (yaw / np.pi + 1.0) * w), 0,
                 w - 1).astype(np.int32)
    py = np.clip(np.floor((1.0 - (pitch + abs(fov_down)) / fov) * h),
                 0, h - 1).astype(np.int32)

    order = np.argsort(depth)[::-1]
    proj_range = np.full((h, w), -1, np.float32)
    proj_xyz = np.full((h, w, 3), -1, np.float32)
    proj_rem = np.full((h, w), -1, np.float32)
    proj_idx = np.full((h, w), -1, np.int32)
    proj_range[py[order], px[order]] = depth[order]
    proj_xyz[py[order], px[order]] = points[order]
    proj_rem[py[order], px[order]] = remissions[order]
    proj_idx[py[order], px[order]] = np.arange(len(depth))[order]
    # `> 0` (not >= 0) is the reference's own off-by-one: the pixel won by
    # point index 0 counts as empty (ldm/lidar_utils.py:215 and
    # metrics/.../histogram.py:270 both use `proj_idx > 0`). Kept, so that
    # RangeNet's inputs are masked exactly as the reference masks them and
    # FRD stays comparable.
    return proj_range, proj_xyz, proj_rem, (proj_idx > 0).astype(np.float32)


def save_generated(image: np.ndarray, filename: str,
                   min_depth: float = 0.5, max_depth: float = 63.0) -> None:
    """Decode a log-range (H, W, 2) image to `<filename>.bin`, float32
    (x, y, z, intensity) rows of the pixels whose depth lies strictly
    between `min_depth` and `max_depth`, in LiDARGen's uniform +3..-25
    degree geometry (ldm/lidar_utils.py:218-250)."""
    h, w = image.shape[:2]
    depth = decode_log_range(image[:, :, 0]).ravel()
    intensity = image[:, :, 1].ravel()

    fov_up = 3.0 / 180.0 * np.pi
    fov_down = -25.0 / 180.0 * np.pi
    fov = abs(fov_down) + abs(fov_up)
    xg, yg = np.meshgrid(np.arange(w) / w, np.arange(h) / h)
    yaw = np.pi * (xg * 2 - 1).ravel()
    pitch = ((1.0 - yg) * fov - abs(fov_down)).ravel()

    pts = np.stack([np.cos(yaw) * np.cos(pitch) * depth,
                    -np.sin(yaw) * np.cos(pitch) * depth,
                    np.sin(pitch) * depth], axis=1)
    mask = (depth > min_depth) & (depth < max_depth)
    out = np.concatenate([pts[mask], intensity[mask, None]],
                         axis=1).astype(np.float32)
    out.tofile(f"{filename}.bin")
