"""Real-robot stack: dual UR5s, grippers, cameras, and RealWorldEnv
(counterpart of flingbot_tpu/real_world/).

API parity with the reference real_world/ package (SURVEY §2.1): the env
keeps SimEnv's episode API and learning stack (value maps in, transformed
obs out, the replay record) and swaps the simulated primitives for
hardware trajectories.  Drivers are plain-socket implementations (no
vendor SDKs) and are import-safe without hardware: connections open
lazily, at the first command."""

from flingbot_tpu_torch.real_world.ur5 import UR5, UR5State
from flingbot_tpu_torch.real_world.ur5_pair import UR5Pair
from flingbot_tpu_torch.real_world.grippers import Gripper, WSG50, RG2
from flingbot_tpu_torch.real_world.cameras import KinectClient, RealSense
from flingbot_tpu_torch.real_world.real_world_env import RealWorldEnv

__all__ = [
    "UR5", "UR5State", "UR5Pair", "Gripper", "WSG50", "RG2",
    "KinectClient", "RealSense", "RealWorldEnv",
]
