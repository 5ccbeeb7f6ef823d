"""Redwood/3DMatch trajectory file IO + transformation error.

The port's own copy of roitr_tpu/eval/trajectory.py (numpy, function for
function; tests/test_torch_registration.py holds the two equal bit for
bit). Rebuilds reference registration/benchmark.py:56-192 without nibabel:
the quaternion conversion is implemented directly (Shepperd's method).
Format spec: http://redwood-data.org/indoor/fileformat.html
"""

from __future__ import annotations

import os

import numpy as np


def mat2quat(m: np.ndarray) -> np.ndarray:
    """Rotation matrix -> unit quaternion [w, x, y, z]."""
    m = np.asarray(m, np.float64)
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    q = np.array([w, x, y, z])
    if q[0] < 0:
        q = -q
    return q


def compute_transformation_error(trans: np.ndarray, info: np.ndarray) -> float:
    """Approximate RMSE of GT correspondences under the residual transform
    (reference benchmark.py:56-77; Redwood protocol)."""
    t = trans[:3, 3]
    r = trans[:3, :3]
    q = mat2quat(r)
    er = np.concatenate([t, q[1:]], axis=0)
    p = er.reshape(1, 6) @ info @ er.reshape(6, 1) / info[0, 0]
    return float(p.item())


def rotation_error_deg(r1: np.ndarray, r2: np.ndarray) -> np.ndarray:
    """Batched angular error in degrees (reference benchmark.py:14-37)."""
    r = np.einsum("bij,bik->bjk", r1, r2)  # R1^T R2
    cos = np.clip((np.trace(r, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    return np.degrees(np.arccos(cos))


def translation_error(t1: np.ndarray, t2: np.ndarray) -> np.ndarray:
    return np.linalg.norm(t1 - t2, axis=(1, 2))


def read_trajectory(filename: str, dim: int = 4):
    """Returns (pair keys (n, 3) str array, transforms (n, dim, dim))."""
    with open(filename) as f:
        lines = f.readlines()
    keys = lines[0 :: dim + 1]
    final_keys = [[p.strip() for p in k.split("\t")[:3]] for k in keys]
    traj = []
    for i, line in enumerate(lines):
        if i % (dim + 1) != 0:
            traj.append(line.split("\t")[:dim])
    traj = np.asarray(traj, dtype=np.float64).reshape(-1, dim, dim)
    return np.asarray(final_keys), traj


def read_trajectory_info(filename: str, dim: int = 6):
    """Returns (num_fragments, covariance matrices (n, 6, 6))."""
    with open(filename) as f:
        contents = f.readlines()
    n_pairs = len(contents) // 7
    info_list = []
    n_frame = 0
    for i in range(n_pairs):
        frame_idx0, frame_idx1, n_frame = [int(x) for x in contents[i * 7].strip().split()]
        info = np.array(
            [contents[i * 7 + j + 1].strip().split("\t") for j in range(dim)], np.float64
        )
        info_list.append(info)
    return n_frame, np.asarray(info_list)


def write_trajectory(traj: np.ndarray, metadata, filename: str, dim: int = 4):
    with open(filename, "w") as f:
        for idx in range(traj.shape[0]):
            if metadata[idx][2]:
                p = traj[idx].tolist()
                f.write("\t".join(map(str, metadata[idx])) + "\n")
                f.write("\n".join("\t".join(map("{0:.12f}".format, p[i])) for i in range(dim)))
                f.write("\n")


def write_est_trajectory(gt_folder: str, exp_dir: str, tsfm_est: np.ndarray):
    """Split the flat estimated-transform list per scene and write est.log
    (reference benchmark_utils.py:229-252)."""
    scene_names = sorted(os.listdir(gt_folder))
    count = 0
    for scene_name in scene_names:
        gt_pairs, _ = read_trajectory(os.path.join(gt_folder, scene_name, "gt.log"))
        est_traj = tsfm_est[count : count + len(gt_pairs)]
        count += len(gt_pairs)
        out_dir = os.path.join(exp_dir, scene_name)
        os.makedirs(out_dir, exist_ok=True)
        metadata = [[k[0], k[1], True] for k in gt_pairs]
        write_trajectory(np.asarray(est_traj), metadata, os.path.join(out_dir, "est.log"))
