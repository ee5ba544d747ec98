"""Episode replay memory with a numpy-only dump (counterpart of
flingbot_tpu/learning/memory.py).

The JAX package dumps each episode into one HDF5 file as one group per
step.  The port writes the same groups as files of a replay DIRECTORY, so
that neither writer nor reader needs h5py:

    <replay dir>/<episode:09d>_step<NN>[_last].npz

The last step of an episode carries the `_last` suffix, as the JAX group
key does.  Inside a step file (`np.savez`, uncompressed: a step holds two
render-size observations, and compression would dominate the replay
time):

    "<key>"              an array value (an HDF5 dataset in the JAX record)
    "@<key>"             a scalar value (an HDF5 group attribute), 0-d
    "<key>/<i:09d>"      item i of a list value (an HDF5 subgroup)

`read_step` turns a file back into (attributes, arrays).
"""

from __future__ import annotations

import os
import random
from copy import deepcopy
from typing import Collection, Dict, List, Tuple

import numpy as np

BASE_KEYS = ["observations", "actions", "rewards", "is_terminal"]
_FIRST_STEP_ONLY = ["visualization_dir", "faces", "gripper_states", "states"]
ATTR_PREFIX = "@"
STEP_SUFFIX = ".npz"


def step_keys(replay_dir: str) -> List[str]:
    """The step keys of a replay directory in sorted order (the order in
    which h5py lists the groups of a JAX record)."""
    if not os.path.isdir(replay_dir):
        return []
    return sorted(f[:-len(STEP_SUFFIX)] for f in os.listdir(replay_dir)
                  if f.endswith(STEP_SUFFIX))


def read_step(replay_dir: str, key: str, arrays: bool | Collection[str]
              = True) -> Tuple[Dict, Dict[str, np.ndarray]]:
    """(attributes, arrays) of one step; arrays=False reads the attributes
    only, a collection of names only those arrays.  Attributes come back
    as numpy scalars, strings as str."""
    attrs, data = {}, {}
    with np.load(os.path.join(replay_dir, key + STEP_SUFFIX),
                 allow_pickle=False) as z:
        for name in z.files:
            if name.startswith(ATTR_PREFIX):
                v = z[name][()]
                attrs[name[len(ATTR_PREFIX):]] = (
                    str(v) if isinstance(v, np.str_) else v)
            elif arrays is True or (arrays and name in arrays):
                data[name] = z[name]
    return attrs, data


class Memory:
    """Append-only episode log with the reference's length invariants
    (Memory, learning/memory.py:32-80)."""

    def __init__(self):
        self.data: Dict[str, list] = {k: [] for k in BASE_KEYS}

    def __len__(self) -> int:
        return len(self.data["observations"])

    def add_observation(self, observation):
        assert (
            len(self.data["rewards"]) == len(self.data["is_terminal"])
            == len(self.data["actions"]) == len(self.data["observations"])
        )
        self.data["observations"].append(deepcopy(observation))

    def add_action(self, action):
        assert (
            len(self.data["rewards"]) == len(self.data["is_terminal"])
            == len(self.data["actions"]) == len(self.data["observations"]) - 1
        )
        self.data["actions"].append(deepcopy(action))

    def add_rewards_and_termination(self, reward, termination):
        assert (
            len(self.data["rewards"]) == len(self.data["is_terminal"])
            == len(self.data["actions"]) - 1
            == len(self.data["observations"]) - 1
        )
        self.data["rewards"].append(float(reward))
        self.data["is_terminal"].append(float(termination))

    def add_value(self, key, value):
        self.data.setdefault(key, []).append(deepcopy(value))

    def _step_entries(self, step: int) -> Dict[str, np.ndarray]:
        entries = {}
        for key, values in self.data.items():
            if key in _FIRST_STEP_ONLY and step != 0:
                continue
            if step >= len(values):
                continue
            v = values[step]
            if isinstance(v, (float, int, str, np.floating, np.integer)):
                entries[ATTR_PREFIX + key] = np.asarray(v)
            elif isinstance(v, list):
                for i, item in enumerate(v):
                    entries[f"{key}/{i:09d}"] = np.asarray(item)
            else:
                entries[key] = np.asarray(v)
        return entries

    def dump(self, replay_dir: str):
        """Write the episode, one file per step, under the next free
        episode number (Memory.dump, memory.py:82-133); returns the
        episode key prefix."""
        if len(self) < 1:
            return None
        os.makedirs(replay_dir, exist_ok=True)
        existing = set(step_keys(replay_dir))
        key_idx = int(max(existing).split("_")[0]) if existing else 0
        while True:
            group_key = f"{key_idx:09d}"
            if (group_key + "_step00" not in existing
                    and group_key + "_step00_last" not in existing):
                break
            key_idx += 1
        for step in range(len(self)):
            step_key = group_key + f"_step{step:02d}"
            if step == len(self) - 1:
                step_key += "_last"
            if step_key in existing:
                step_key += "_" + str(random.randint(0, 100000))
            np.savez(os.path.join(replay_dir, step_key + STEP_SUFFIX),
                     **self._step_entries(step))
        return group_key
