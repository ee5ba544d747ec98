"""Gripper ("picker") kinematics, batched (counterpart of
flingbot_tpu/engine/picker.py).

A picker is a kinematic sphere; with its pick flag raised it grasps the
nearest free particle within threshold + picker_radius + particle_radius,
pins that particle's inverse mass to 0 and co-moves it; lowering the flag
restores the saved inverse mass (SoftGym Picker, flex_utils.py:35-205).
"""

from __future__ import annotations

import torch

from flingbot_tpu_torch.engine.state import ClothState

DEFAULT_PICKER_RADIUS = 0.02  # SimEnv passes picker_radius = grasp_height
PICK_THRESHOLD = 0.005


def _take(x, idx):
    """x (B, N) or (B, C, N) at per-env slot idx (B,) -> (B,) / (B, C)."""
    if x.dim() == 2:
        return x.gather(1, idx[:, None])[:, 0]
    return x.gather(2, idx.view(-1, 1, 1).expand(-1, x.shape[1], 1))[..., 0]


def _put(x, idx, val):
    """x with slot idx (B,) set to val ((B,) / (B, C)); returns a copy."""
    x = x.clone()
    if x.dim() == 2:
        x.scatter_(1, idx[:, None], val[:, None].to(x.dtype))
    else:
        x.scatter_(2, idx.view(-1, 1, 1).expand(-1, x.shape[1], 1),
                   val[..., None].to(x.dtype))
    return x


def picker_step(state: ClothState, action: torch.Tensor, *,
                picker_radius: float = DEFAULT_PICKER_RADIUS,
                particle_radius: float = 0.00625,
                dt: float = 0.01) -> ClothState:
    """Apply one action [dx, dy, dz, pick_flag] per picker, per env.
    action (B, P, 4).  Unpick -> move -> maybe grasp nearest -> co-move
    the grasped particle, which also takes the picker's velocity."""
    B, N = state.inv_mass.shape
    positions, velocities = state.positions, state.velocities
    inv_mass = state.inv_mass
    picker_pos = state.picker_pos.clone()
    picked_idx = state.picked_idx.clone()
    grasp_range = PICK_THRESHOLD + picker_radius + particle_radius
    slots = torch.arange(N, device=positions.device)[None]

    for i in range(picker_pos.shape[1]):
        delta = action[:, i, :3]
        flag = action[:, i, 3] > 0.5
        cur = picked_idx[:, i]
        has = cur >= 0
        safe = cur.clamp(0, N - 1)

        # 1. unpick: restore the saved inverse mass
        release = ~flag & has
        inv_mass = _put(inv_mass, safe, torch.where(
            release, _take(state.rest_inv_mass, safe), _take(inv_mass, safe)))
        cur = torch.where(release, -1, cur)
        has = cur >= 0

        # 2. move the picker
        picker_pos[:, i] = picker_pos[:, i] + delta

        # 3. grasp the nearest free particle in range
        d = positions - picker_pos[:, i, :, None]
        dist = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
                          + d[:, 2] * d[:, 2])
        taken = torch.zeros_like(state.active)
        for j in range(picker_pos.shape[1]):
            if j != i:
                oid = picked_idx[:, j:j + 1]
                taken = taken | ((slots == oid) & (oid >= 0))
        eligible = state.active & ~taken & (dist <= grasp_range)
        dist_masked = torch.where(eligible, dist, float("inf"))
        nearest = torch.argmin(dist_masked, dim=1)
        can_pick = flag & ~has & torch.isfinite(_take(dist_masked, nearest))
        cur = torch.where(can_pick, nearest, cur)
        has = cur >= 0

        # 4. co-move the grasped particle, pin its inverse mass to 0
        move = flag & has
        safe = cur.clamp(0, N - 1)
        tgt = _take(positions, safe) + delta
        positions = _put(positions, safe, torch.where(
            move[:, None], tgt, _take(positions, safe)))
        inv_mass = _put(inv_mass, safe, torch.where(
            move, 0.0, _take(inv_mass, safe)))
        velocities = _put(velocities, safe, torch.where(
            move[:, None], delta / dt, _take(velocities, safe)))
        picked_idx[:, i] = cur

    return state.replace(positions=positions, velocities=velocities,
                         inv_mass=inv_mass, picker_pos=picker_pos,
                         picked_idx=picked_idx)


def set_picker_positions(state: ClothState, pos) -> ClothState:
    """Teleport the pickers without touching grasp state."""
    pos = torch.as_tensor(pos, dtype=torch.float32, device=state.device)
    return state.replace(
        picker_pos=pos.reshape(-1, state.picker_pos.shape[1], 3).expand(
            state.batch, -1, -1).clone())


def release_all(state: ClothState) -> ClothState:
    """Drop every grasp and restore the saved inverse masses."""
    N = state.num_particles
    inv_mass = state.inv_mass
    for i in range(state.picked_idx.shape[1]):
        idx = state.picked_idx[:, i]
        safe = idx.clamp(0, N - 1)
        inv_mass = _put(inv_mass, safe, torch.where(
            idx >= 0, _take(state.rest_inv_mass, safe),
            _take(inv_mass, safe)))
    return state.replace(inv_mass=inv_mass,
                         picked_idx=torch.full_like(state.picked_idx, -1))
