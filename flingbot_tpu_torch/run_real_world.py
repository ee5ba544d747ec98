"""Real-world training/finetuning driver (counterpart of the root
run_real_world.py; reference run_real_world.py:18-94): the same train
loop as run_sim against a single synchronous RealWorldEnv, logging a
datapoints/hour rate.

    python -m flingbot_tpu_torch.run_real_world --log runs/real \
        --load runs/exp1/latest_ckpt.pth --calibration calibration.npz

Takes run_sim's flags plus --calibration (calibrate_camera's output) and
--cloth_name.  The replay record is the directory `{log}/replay_buffer/`.
The policy and the observation transforms run on the card (--device cpu
on the CPU); the rig's addresses are in real_world/setup.py.
"""

from __future__ import annotations

import os
import pickle
import time

import numpy as np

from flingbot_tpu_torch.device import resolve_device
from flingbot_tpu_torch.learning.dataset import GraspDataset
from flingbot_tpu_torch.learning.nets import MaximumValuePolicy
from flingbot_tpu_torch.learning.train import optimize
from flingbot_tpu_torch.real_world import (
    RG2,
    WSG50,
    KinectClient,
    RealSense,
    RealWorldEnv,
    UR5,
    UR5Pair,
)
from flingbot_tpu_torch.real_world import setup as rw
from flingbot_tpu_torch.utils.checkpoint import (
    load_checkpoint, save_checkpoint)
from flingbot_tpu_torch.utils.config import config_parser, seed_all
from flingbot_tpu_torch.utils.stats import get_dataset_size


def build_env(args, dataset_path, device):
    left = UR5(rw.LEFT_UR5_IP)
    right = UR5(rw.RIGHT_UR5_IP)
    pair = UR5Pair(left, right)
    grippers = (WSG50(rw.WSG50_IP, rw.WSG50_PORT), RG2(right))
    top = KinectClient(rw.KINECT_RPC_URL)
    front = RealSense(rw.REALSENSE_IP, rw.REALSENSE_PORT)
    calib = np.load(args.calibration)
    return RealWorldEnv(
        replay_buffer_path=dataset_path,
        top_camera=top,
        front_camera=front,
        ur5_pair=pair,
        grippers=grippers,
        cam_intrinsics=calib["intrinsics"],
        cam_extrinsics=calib["cam_to_world"],
        **{**vars(args), "device": device},
    )


def main(argv=None):
    parser = config_parser()
    parser.add_argument("--calibration", default="calibration.npz")
    parser.add_argument("--cloth_name", default="white_rect")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    seed_all(args.seed)
    os.makedirs(args.log, exist_ok=True)
    policy = MaximumValuePolicy(**{**vars(args), "device": device})
    if args.load:
        load_checkpoint(args.load, policy)
    dataset_path = f"{args.log}/replay_buffer"
    with open(args.log + "/args.pkl", "wb") as f:
        pickle.dump(vars(args), f)
    env = build_env(args, dataset_path, device)

    obs = env.reset()
    start = time.time()
    i = 0
    while True:
        vms = policy.value_maps(obs)
        obs = env.step(vms)
        i += 1
        rate = i / max(time.time() - start, 1) * 3600
        print(f"[run_real_world] {i} steps, {rate:.1f} datapoints/hour")
        size = get_dataset_size(dataset_path)
        if not args.eval and size > args.warmup:
            optimize(
                policy,
                lambda prim: GraspDataset(
                    dataset_path,
                    filter_fn=lambda a: a.get("action_primitive") == prim,
                    **vars(args)),
                batch_size=args.batch_size,
            )
            save_checkpoint(f"{args.log}/latest_ckpt.pth", policy)


if __name__ == "__main__":
    main()
