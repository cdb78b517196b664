"""ERP visualization of spherical boxes.

Each box edge is a great-circle arc: the exact boundary-plane corners (the
construction of the unbiased IoU) are joined by slerps along each edge,
projected to ERP pixels, and the polylines split at the theta seam. numpy
and PIL only; PIL is imported by the function that draws.
"""

from __future__ import annotations

import numpy as np

_PALETTE = [
    (255, 99, 71), (60, 179, 113), (65, 105, 225), (255, 215, 0),
    (186, 85, 211), (0, 206, 209), (255, 140, 0), (154, 205, 50),
    (220, 20, 60), (100, 149, 237),
]


def _box_corners_sphere(box_deg: np.ndarray) -> np.ndarray:
    """(4|5,) degree box -> (4, 3) unit corner vectors (the unbiased IoU's
    planes)."""
    theta, phi = np.deg2rad(box_deg[0]), np.deg2rad(box_deg[1])
    hx, hy = np.deg2rad(box_deg[2]) / 2, np.deg2rad(box_deg[3]) / 2
    st, ct, sp, cp = np.sin(theta), np.cos(theta), np.sin(phi), np.cos(phi)
    look = np.array([sp * ct, sp * st, cp])
    right = np.array([-st, ct, 0.0])
    up = np.array([-cp * ct, -cp * st, sp])
    n_left = -np.cos(hx) * right + np.sin(hx) * look
    n_right = np.cos(hx) * right + np.sin(hx) * look
    n_up = -np.cos(hy) * up + np.sin(hy) * look
    n_down = np.cos(hy) * up + np.sin(hy) * look
    normals = np.stack([n_left, n_right, n_up, n_down])
    if box_deg.shape[0] == 5:
        g = np.deg2rad(box_deg[4])
        cg, sg = np.cos(g), np.sin(g)
        k = look

        def rot(v):
            return (v * cg + np.cross(k, v) * sg
                    + k * np.dot(k, v) * (1 - cg))

        normals = np.stack([rot(n) for n in normals])
    pairs = [(0, 2), (2, 1), (1, 3), (3, 0)]  # CCW corner order
    corners = []
    for a, b in pairs:
        c = np.cross(normals[a], normals[b])
        corners.append(c / (np.linalg.norm(c) + 1e-12))
    return np.stack(corners)


def _slerp(a: np.ndarray, b: np.ndarray, n: int) -> np.ndarray:
    dot = np.clip(np.dot(a, b), -1 + 1e-9, 1 - 1e-9)
    omega = np.arccos(dot)
    t = np.linspace(0.0, 1.0, n)[:, None]
    return ((np.sin((1 - t) * omega) * a + np.sin(t * omega) * b)
            / np.sin(omega))


def erp_box_polyline(box_deg, img_size=(512, 1024), samples_per_edge=24):
    """Spherical box -> list of pixel polylines (split at the theta seam)."""
    h, w = img_size
    corners = _box_corners_sphere(np.asarray(box_deg, np.float64))
    pts = []
    for i in range(4):
        pts.append(_slerp(corners[i], corners[(i + 1) % 4],
                          samples_per_edge)[:-1])
    pts = np.concatenate(pts + [corners[:1]])  # closed loop
    theta = np.mod(np.arctan2(pts[:, 1], pts[:, 0]), 2 * np.pi)
    phi = np.arccos(np.clip(pts[:, 2], -1, 1))
    u = theta / (2 * np.pi) * w
    v = phi / np.pi * h
    # split where the polyline wraps the seam
    segments, start = [], 0
    for k in range(1, len(u)):
        if abs(u[k] - u[k - 1]) > w / 2:
            segments.append(np.stack([u[start:k], v[start:k]], -1))
            start = k
    segments.append(np.stack([u[start:], v[start:]], -1))
    return [s for s in segments if len(s) >= 2]


def draw_boxes(image: np.ndarray, boxes, labels=None, scores=None,
               class_names=None, score_thr: float = 0.0, width: int = 2,
               color=None):
    """Draw spherical boxes on an ERP image; returns an RGB uint8 array.

    ``color``: an RGB tuple in place of the per-class palette (ground truth
    green against red predictions in ``analyze_results``)."""
    from PIL import Image, ImageDraw

    img = Image.fromarray(np.ascontiguousarray(image.astype(np.uint8)))
    draw = ImageDraw.Draw(img)
    h, w = image.shape[:2]
    boxes = np.asarray(boxes)
    fixed_color = tuple(color) if color is not None else None
    for i, box in enumerate(boxes):
        if scores is not None and scores[i] < score_thr:
            continue
        label = int(labels[i]) if labels is not None else 0
        color = fixed_color or _PALETTE[label % len(_PALETTE)]
        for seg in erp_box_polyline(box, (h, w)):
            draw.line([tuple(p) for p in seg], fill=color, width=width)
        tag = None
        if class_names is not None and 0 <= label < len(class_names):
            tag = str(class_names[label])
        elif labels is not None:
            tag = str(label)
        if scores is not None and tag is not None:
            tag = f"{tag}:{scores[i]:.2f}"
        if tag:
            cx = box[0] / 360.0 * w
            cy = box[1] / 180.0 * h
            draw.text((cx, cy), tag, fill=color)
    return np.asarray(img)


def imshow_det_bboxes(img, boxes, labels, class_names=None, score_thr=0.3,
                      out_file=None):
    """The reference's ``sph_draw.imshow_det_bboxes``: ``boxes`` may carry a
    trailing score column, told apart from a 5-dof box's angle by its
    range (scores are <= 1)."""
    boxes = np.asarray(boxes)
    scores = None
    if boxes.shape[-1] in (5, 6) and np.all(boxes[:, -1] <= 1.0 + 1e-6):
        scores = boxes[:, -1]
        boxes = boxes[:, :-1]
    out = draw_boxes(img, boxes, labels, scores, class_names, score_thr)
    if out_file:
        from PIL import Image

        Image.fromarray(out).save(out_file)
    return out
