"""Action drawing on observation images (counterpart of
flingbot_tpu/utils/vis.py, the reference's draw_action family,
environment/utils.py:283-432): the fling draws circled grasp points joined
by a line, stretchdrag adds a drag arrow, drag and place draw arrows.
Host-side numpy and cv2; collect_stats' img_action panel and the
visualize gallery use it."""

from __future__ import annotations

import numpy as np


def _cv2():
    import cv2

    return cv2


def draw_circled_lines(img, pixels, thickness=1):
    """Fling: green circle (p1) -- yellow line -- red circle (p2).
    pixels: ((row1, col1), (row2, col2)); img float RGB in [0, 1]."""
    cv2 = _cv2()
    (r1, c1), (r2, c2) = (tuple(int(v) for v in p) for p in pixels)
    img = cv2.circle(img, (c1, r1), thickness * 2, (0, 1, 0), thickness)
    img = cv2.line(img, (c1, r1), (c2, r2), (1, 1, 0), thickness)
    img = cv2.circle(img, (c2, r2), thickness * 2, (1, 0, 0), thickness)
    return img


def draw_arrow(img, pixels, color=(0, 1, 1), thickness=1):
    cv2 = _cv2()
    (r1, c1), (r2, c2) = (tuple(int(v) for v in p) for p in pixels)
    return cv2.arrowedLine(img, (c1, r1), (c2, r2), color, thickness)


def draw_circled_lines_with_arrow(img, pixels, thickness=1):
    """Stretchdrag: grasp pair + perpendicular drag-direction arrow."""
    cv2 = _cv2()
    img = draw_circled_lines(img, pixels, thickness)
    p1 = np.asarray(pixels[0], float)
    p2 = np.asarray(pixels[1], float)
    direction = np.cross(
        np.append(p1 - p2, 0.0), np.array([0.0, 0.0, 1.0]))[:2]
    start = ((p1 + p2) / 2).astype(int)
    end = (start + direction).astype(int)
    return cv2.arrowedLine(
        img, (int(start[1]), int(start[0])), (int(end[1]), int(end[0])),
        (1, 0, 0), thickness)


def draw_action(img, action_primitive: str, pixels, thickness=1):
    """Dispatch matching the reference draw_action (utils.py:350-366)."""
    img = np.ascontiguousarray(img, np.float32)
    if action_primitive == "fling":
        return draw_circled_lines(img, pixels, thickness)
    if action_primitive == "stretchdrag":
        return draw_circled_lines_with_arrow(img, pixels, thickness)
    if action_primitive == "drag":
        return draw_arrow(img, pixels, (1, 0, 1), thickness)
    if action_primitive == "place":
        return draw_arrow(img, pixels, (0, 1, 1), thickness)
    raise NotImplementedError(action_primitive)
