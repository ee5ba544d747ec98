"""Open-loop dual-arm fling trajectory (reference real_world/fling.py).

Blended multi-waypoint movel programs: swing forward at height, swing back
while descending, lay down, release.  When only one gripper holds cloth the
free arm parks and the holder performs a single-arm fling."""

from __future__ import annotations

# tool-down orientation (axis-angle)
TOOL_DOWN = [2.22, -2.22, 0.0]


def _pose(x, y, z):
    return [x, y, z] + TOOL_DOWN


def fling(ur5_pair, grippers, width: float, fling_height: float = 0.45,
          swing: float = 0.55, lay_height: float = 0.05,
          single_arm: "int | None" = None):
    """Execute the fling with grasp distance `width` (meters between
    grippers).  single_arm: None = both, 0/1 = only that arm holds."""
    hw = width / 2
    forward = [
        [_pose(hw, -swing / 2, fling_height),
         _pose(-hw, -swing / 2, fling_height)],
        [_pose(hw, swing / 2, fling_height),
         _pose(-hw, swing / 2, fling_height)],
        [_pose(hw, swing / 2 - 0.1, lay_height),
         _pose(-hw, swing / 2 - 0.1, lay_height)],
        [_pose(hw, -swing / 4, lay_height),
         _pose(-hw, -swing / 4, lay_height)],
    ]
    if single_arm is None:
        waypoints_pair = [[w[0] for w in forward], [w[1] for w in forward]]
        ur5_pair.movel_waypoints(waypoints_pair, a=8.0, v=2.5, blend=0.05)
    else:
        holder = ur5_pair.arms[single_arm]
        holder.movel_waypoints(
            [w[single_arm] for w in forward], a=8.0, v=2.5, blend=0.05)
    for g in grippers:
        g.open()
    ur5_pair.out_of_the_way()
