"""Hand-eye calibration for the top-down camera (counterpart of the root
calibrate_camera.py; reference calibrate_camera.py:12-171): move a
checkerboard mounted on the gripper through a 3D grid of robot poses,
detect it in the camera, solve the rigid camera->world transform by SVD
(Kabsch), then refine the depth scale with Nelder-Mead.

Usage (with a rig):
    python -m flingbot_tpu_torch.calibrate_camera --output calibration.npz

The calibration itself is host arithmetic; as every entry point of the
port, main() first checks for the card that run_real_world will use
(--device cpu skips the check).
"""

from __future__ import annotations

import argparse

import numpy as np


def detect_checkerboard(rgb, depth, intrinsics, pattern=(4, 5)):
    """Returns the checkerboard center in camera coordinates, or None."""
    import cv2

    gray = cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY)
    found, corners = cv2.findChessboardCorners(
        gray, pattern, flags=cv2.CALIB_CB_ADAPTIVE_THRESH)
    if not found:
        return None
    corners = cv2.cornerSubPix(
        gray, corners, (5, 5), (-1, -1),
        (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 30, 1e-3))
    c = corners.reshape(-1, 2).mean(axis=0)
    col, row = c
    z = float(depth[int(round(row)), int(round(col))])
    if z <= 0:
        return None
    x = (col - intrinsics[0, 2]) * z / intrinsics[0, 0]
    y = (row - intrinsics[1, 2]) * z / intrinsics[1, 1]
    return np.array([x, y, z])


def rigid_transform(cam_pts: np.ndarray, world_pts: np.ndarray) -> np.ndarray:
    """Kabsch/SVD best-fit rigid transform cam -> world (4x4)."""
    cc = cam_pts.mean(axis=0)
    wc = world_pts.mean(axis=0)
    H = (cam_pts - cc).T @ (world_pts - wc)
    U, _, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    R = Vt.T @ np.diag([1.0, 1.0, d]) @ U.T
    t = wc - R @ cc
    out = np.eye(4)
    out[:3, :3] = R
    out[:3, 3] = t
    return out


def refine_depth_scale(cam_pts, world_pts):
    """Nelder-Mead over a scalar depth multiplier (reference
    calibrate_camera.py's final optimization)."""
    from scipy.optimize import minimize

    def cost(s):
        s = np.asarray(s).reshape(-1)[0]
        scaled = cam_pts * np.array([1.0, 1.0, float(s)])
        T = rigid_transform(scaled, world_pts)
        pred = (T[:3, :3] @ scaled.T).T + T[:3, 3]
        return float(np.linalg.norm(pred - world_pts, axis=1).mean())

    res = minimize(cost, x0=[1.0], method="Nelder-Mead")
    return float(res.x[0])


def calibrate(ur5, gripper_offset, camera, grid_xs, grid_ys, grid_zs,
              tool_down=(2.22, -2.22, 0.0)):
    """Drive the checkerboard through the pose grid, collect pairs, solve."""
    intr = camera.get_intrinsics()
    cam_pts, world_pts = [], []
    for x in grid_xs:
        for y in grid_ys:
            for z in grid_zs:
                ur5.movel([x, y, z, *tool_down], v=0.2)
                rgb, depth = camera.get_rgbd(repeats=3)
                c = detect_checkerboard(rgb, depth, intr)
                if c is None:
                    continue
                cam_pts.append(c)
                world_pts.append(np.array([x, y, z]) + gripper_offset)
    cam_pts = np.asarray(cam_pts)
    world_pts = np.asarray(world_pts)
    scale = refine_depth_scale(cam_pts, world_pts)
    T = rigid_transform(cam_pts * np.array([1, 1, scale]), world_pts)
    err = np.linalg.norm(
        (T[:3, :3] @ (cam_pts * [1, 1, scale]).T).T + T[:3, 3] - world_pts,
        axis=1)
    return {"cam_to_world": T, "depth_scale": scale,
            "intrinsics": intr, "mean_error": float(err.mean())}


def main(argv=None):
    from flingbot_tpu_torch.device import resolve_device
    from flingbot_tpu_torch.real_world import UR5, KinectClient
    from flingbot_tpu_torch.real_world import setup as rw

    p = argparse.ArgumentParser()
    p.add_argument("--output", default="calibration.npz")
    p.add_argument("--arm", choices=["left", "right"], default="left")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    resolve_device(args.device)
    ur5 = UR5(rw.LEFT_UR5_IP if args.arm == "left" else rw.RIGHT_UR5_IP)
    cam = KinectClient(rw.KINECT_RPC_URL)
    result = calibrate(
        ur5, gripper_offset=np.array([0, 0, -0.05]), camera=cam,
        grid_xs=np.linspace(0.2, 0.6, 3),
        grid_ys=np.linspace(-0.2, 0.2, 3),
        grid_zs=np.linspace(0.15, 0.45, 3))
    np.savez(args.output, **result)
    print(f"saved {args.output}; mean error "
          f"{result['mean_error'] * 1000:.1f} mm")
    return result


if __name__ == "__main__":
    main()
