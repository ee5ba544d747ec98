"""Replay dataset: the port's replay directory (learning/memory.py) read
into training batches (counterpart of flingbot_tpu/learning/dataset.py).

GraspDataset (reference: learning/utils.py:12-100): reward =
(postaction - preaction) coverage, normalized by the task's max coverage
(or min-max normalized with the recorded constants); RGB optionally
color-jittered; optional mirror or dihedral augmentation; the validity
check deletes malformed step files.  It makes the same numpy Generator
calls in the same order as the JAX class and lists steps in the same
order (step_keys sorts as h5py lists groups), so with the same seed and
the same records its batches are the JAX dataset's, bit for bit.
"""

from __future__ import annotations

import os
import queue
import threading
import zipfile
from typing import Callable, Optional

import numpy as np

from flingbot_tpu_torch.learning.memory import (
    STEP_SUFFIX, read_step, step_keys)

REWARDS_MAX = 0.20572495126190674
REWARDS_MIN = -0.11034914070874759
_ARRAYS = ("observations", "actions")


def color_jitter(rng: np.random.Generator, rgb: np.ndarray,
                 brightness=0.2, contrast=0.3, saturation=0.5,
                 hue=0.5) -> np.ndarray:
    """Cheap HSV-free approximation of torchvision ColorJitter
    (learning/utils.py:28-34) on a (3, H, W) float image in [0, 1]."""
    out = rgb
    b = 1.0 + rng.uniform(-brightness, brightness)
    out = out * b
    c = 1.0 + rng.uniform(-contrast, contrast)
    mean = out.mean()
    out = (out - mean) * c + mean
    s = 1.0 + rng.uniform(-saturation, saturation)
    gray = out.mean(axis=0, keepdims=True)
    out = (out - gray) * s + gray
    # hue: rotate channels toward a random permutation blend
    h = rng.uniform(0, hue)
    rolled = np.roll(out, 1, axis=0)
    out = (1 - h) * out + h * rolled
    return np.clip(out, 0.0, 1.0).astype(np.float32)


class GraspDataset:
    """Transitions of a replay directory.  filter_fn, when given, takes a
    step's attributes (read_step) and keeps the step when true.

    Mirror augmentation x-flips the observation and the action mask
    together; dihedral augmentation applies one of the 8 D4 transforms
    (cloth dynamics have no chirality and are invariant under rotation
    about the vertical, and the views are square)."""

    def __init__(
        self,
        replay_dir: str,
        depth_only: bool = False,
        rgb_only: bool = False,
        check_validity: bool = False,
        filter_fn: Optional[Callable] = None,
        obs_color_jitter: bool = True,
        use_normalized_coverage: bool = True,
        mirror_augment: bool = False,
        dihedral_augment: bool = False,
        seed: int = 0,
        **_unused,
    ):
        if depth_only and rgb_only:
            raise ValueError("depth_only and rgb_only exclude each other")
        self.replay_dir = replay_dir
        self.filter_fn = filter_fn
        self.depth_only = depth_only
        self.rgb_only = rgb_only
        self.obs_color_jitter = obs_color_jitter
        self.mirror_augment = mirror_augment
        self.dihedral_augment = dihedral_augment
        self.use_normalized_coverage = use_normalized_coverage
        self.rng = np.random.default_rng(seed)
        self._seen: set = set()
        self.keys: list = []
        self.refresh()
        if check_validity:
            for k in list(self.keys):
                self._check_validity(k)
            self._seen = set()
            self.keys = []
            self.refresh()

    def refresh(self) -> int:
        """Scan only the steps added since the last call; returns the
        number of keys appended.  A step file that cannot be read is
        left out."""
        added = 0
        for k in step_keys(self.replay_dir):
            if k in self._seen:
                continue
            self._seen.add(k)
            try:
                keep = self.filter_fn is None or self.filter_fn(
                    read_step(self.replay_dir, k, arrays=False)[0])
            except (OSError, ValueError, zipfile.BadZipFile):
                continue
            if keep:
                self.keys.append(k)
                added += 1
        return added

    def _check_validity(self, key):
        """Delete a malformed step file (learning/utils.py:58-71)."""
        path = os.path.join(self.replay_dir, key + STEP_SUFFIX)
        if not os.path.exists(path):
            return
        try:
            attrs, arrays = read_step(self.replay_dir, key, _ARRAYS)
        except (OSError, ValueError, zipfile.BadZipFile):
            bad = True
        else:
            bad = (
                "actions" not in arrays
                or "observations" not in arrays
                or "postaction_coverage" not in attrs
                or "preaction_coverage" not in attrs
            )
            if not bad:
                bad = (arrays["actions"].sum() != 1
                       or arrays["observations"].ndim == 4)
        if bad:
            os.remove(path)

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, index: int):
        attrs, arrays = read_step(self.replay_dir, self.keys[index], _ARRAYS)
        reward = float(
            attrs["postaction_coverage"] - attrs["preaction_coverage"])
        if self.use_normalized_coverage:
            reward /= float(attrs["max_coverage"])
        else:
            reward = (reward - REWARDS_MIN) / (REWARDS_MAX - REWARDS_MIN)
        obs = np.asarray(arrays["observations"], np.float32)
        action = np.asarray(arrays["actions"]).astype(bool)
        if self.rgb_only:
            rgb = obs[:3]
            if self.obs_color_jitter:
                rgb = color_jitter(self.rng, rgb)
            obs = np.concatenate([rgb, obs[3:4]], axis=0)
        if self.dihedral_augment:
            k = int(self.rng.integers(0, 4))
            if k:
                obs = np.rot90(obs, k, axes=(-2, -1))
                action = np.rot90(action, k, axes=(-2, -1))
            if self.rng.random() < 0.5:
                obs = obs[..., ::-1]
                action = action[..., ::-1]
            obs = np.ascontiguousarray(obs)
            action = np.ascontiguousarray(action)
        elif self.mirror_augment and self.rng.random() < 0.5:
            obs = obs[..., ::-1].copy()
            action = action[..., ::-1].copy()
        return obs, action, np.float32(reward)

    def sample_batch(self, batch_size: int):
        """Uniform random batch -> (obs (B,4,D,D), mask (B,D,D), r (B,))."""
        if len(self) == 0:
            return None
        idx = self.rng.integers(0, len(self), batch_size)
        obs, masks, rewards = zip(*(self[int(i)] for i in idx))
        return (
            np.stack(obs),
            np.stack(masks).astype(np.float32),
            np.asarray(rewards, np.float32),
        )


class PrefetchLoader:
    """Background-thread batch prefetcher (the reference's
    DataLoader(num_workers=...), utils.py:171-176): batches are assembled
    on a daemon thread while the card trains on the previous one."""

    def __init__(self, dataset: GraspDataset, batch_size: int,
                 queue_depth: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self._q = queue.Queue(maxsize=queue_depth)
        self._stop = False
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while not self._stop:
            batch = self.dataset.sample_batch(self.batch_size)
            if batch is None:
                self._stop = True
                break
            self._q.put(batch)

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop and self._q.empty():
            raise StopIteration
        return self._q.get()

    def close(self):
        self._stop = True
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
