"""Scene visualization (port of tools/visual_utils.py, the counterpart of
the reference's tools/visual_utils/: open3d_vis_utils.py, visualize_utils.py,
visualize_utils_gt.py).

The default backend renders the scene (points with a distance gradient,
predicted boxes in blue, gt boxes in magenta, heading crosses, IoU and
score annotations, in-box point highlighting, a BEV grid) through
matplotlib's 3D projection into a PNG; where open3d imports,
`draw_scenes(..., backend="open3d")` returns the reference's geometry list
(a PointCloud and a LineSet per box with the heading-cross lines,
open3d_vis_utils.py:364-386). matplotlib and open3d are imported only
inside the drawing functions.

All geometry is numpy (`data/np_geometry.py`, the reference's
boxes_to_corners_3d corner order, open3d_vis_utils.py:113-137).
"""
from __future__ import annotations

import numpy as np

from ..data.np_geometry import boxes_to_corners_3d, pairwise_iou_bev, points_in_boxes

# Per-class wireframe colors (reference box_colormap: pred = blue,
# box_colormap_gt: gt = magenta; open3d_vis_utils.py:23-57).
PRED_COLOR = (0.0, 0.0, 1.0)
GT_COLOR = (1.0, 0.0, 0.8)

# Edges of the corner layout produced by boxes_to_corners_3d: bottom ring
# (0-1-2-3), top ring (4-5-6-7), verticals, plus the reference's two extra
# heading-cross lines on the +x face ([0,5],[1,4] in its corner frame).
_BOX_EDGES = np.array(
    [(0, 1), (1, 2), (2, 3), (3, 0),
     (4, 5), (5, 6), (6, 7), (7, 4),
     (0, 4), (1, 5), (2, 6), (3, 7),
     (0, 5), (1, 4)]
)


def gradient_point_colors(points: np.ndarray, radius: float = 70.0):
    """Distance-based purple→yellow gradient, (N, 3) floats in [0, 1]
    (reference gradient_point_cloud_color_map, open3d_vis_utils.py:177-249:
    a piecewise R/G/B ramp 127,0,255 → 255,255,0 over `radius` meters)."""
    dist = np.sqrt(points[:, 0] ** 2 + points[:, 1] ** 2) / radius
    total = 127.0 + 255.0 + 255.0 + 255.0
    v = np.clip(dist * total, 0.0, total)
    r = np.where(v < 127, 127 - v, np.where(v < 637, 0.0, np.minimum(v - 637, 255)))
    g = np.where(v < 127, 0.0, np.minimum(v - 127, 255.0))
    b = np.where(v < 382, 255.0, np.maximum(255.0 - np.maximum(v - 382, 0), 0.0))
    return np.stack([r, g, b], axis=-1) / 255.0


def get_coor_colors(obj_labels: np.ndarray) -> np.ndarray:
    """Per-instance RGB colors for integer cluster labels (N,) → (N, 3)
    (reference get_coor_colors, open3d_vis_utils.py:67-83 — XKCD palette;
    here a deterministic HSV wheel so no matplotlib import is needed)."""
    labels = np.asarray(obj_labels, dtype=np.int64)
    n = int(labels.max()) + 1 if labels.size else 1
    hues = (np.arange(max(n, 1)) * 0.61803398875) % 1.0  # golden-ratio spacing
    h6 = hues * 6.0
    x = 1.0 - np.abs(h6 % 2.0 - 1.0)
    sector = h6.astype(np.int64) % 6
    table = np.stack([np.ones_like(x), x, np.zeros_like(x)], axis=-1)
    order = np.array([[0, 1, 2], [1, 0, 2], [2, 0, 1],
                      [2, 1, 0], [1, 2, 0], [0, 2, 1]])
    palette = np.take_along_axis(table, order[sector], axis=-1)
    return palette[labels]


def calculate_iou(pred_boxes: np.ndarray, gt_boxes: np.ndarray) -> np.ndarray:
    """Best-GT BEV IoU per predicted box (reference
    visualize_utils_gt.calculate_iou, :295 — used to annotate pred boxes)."""
    if len(pred_boxes) == 0 or len(gt_boxes) == 0:
        return np.zeros((len(pred_boxes),), np.float32)
    iou = pairwise_iou_bev(pred_boxes[:, :7].astype(np.float32),
                           gt_boxes[:, :7].astype(np.float32))
    return iou.max(axis=1)


def _draw_corners3d(ax, corners3d, color, labels=None, scores=None,
                    ious=None, class_names=None, linewidth=1.2):
    """Wireframes for (N, 8, 3) corners on a matplotlib 3D axis
    (reference draw_corners3d, visualize_utils.py:173 + the gt variant's
    IoU text, visualize_utils_gt.py:212)."""
    from mpl_toolkits.mplot3d.art3d import Line3DCollection

    segs = corners3d[:, _BOX_EDGES]              # (N, E, 2, 3)
    ax.add_collection3d(
        Line3DCollection(segs.reshape(-1, 2, 3), colors=[color],
                         linewidths=linewidth)
    )
    for i, c in enumerate(corners3d):
        parts = []
        if class_names is not None and labels is not None:
            li = int(labels[i])
            if 0 < li <= len(class_names):
                parts.append(class_names[li - 1])
        if scores is not None:
            parts.append(f"{float(scores[i]):.2f}")
        if ious is not None:
            parts.append(f"iou {float(ious[i]):.2f}")
        if parts:
            top = c[4:].mean(axis=0)
            ax.text(top[0], top[1], top[2] + 0.3, " ".join(parts),
                    color=color, fontsize=6)


def _draw_grid(ax, bv_range=(-60, -60, 60, 60), grid_size=20, z=0.0):
    """Ground-plane BEV grid (reference draw_multi_grid_range,
    visualize_utils.py:126-140)."""
    x0, y0, x1, y1 = bv_range
    for x in range(int(x0), int(x1) + 1, grid_size):
        ax.plot([x, x], [y0, y1], [z, z], color=(0.35, 0.35, 0.35),
                linewidth=0.4)
    for y in range(int(y0), int(y1) + 1, grid_size):
        ax.plot([x0, x1], [y, y], [z, z], color=(0.35, 0.35, 0.35),
                linewidth=0.4)


def _open3d_geometries(points, gt_boxes, ref_boxes, point_colors):
    """Build the reference's open3d geometry list (draw_scenes +
    translate_boxes_to_open3d_instance, open3d_vis_utils.py:252-409).
    Only callable when open3d is importable."""
    import open3d

    geoms = []
    pts = open3d.geometry.PointCloud()
    pts.points = open3d.utility.Vector3dVector(points[:, :3])
    pts.colors = open3d.utility.Vector3dVector(
        point_colors if point_colors is not None
        else gradient_point_colors(points)
    )
    geoms.append(pts)
    for boxes, color in ((gt_boxes, GT_COLOR), (ref_boxes, PRED_COLOR)):
        if boxes is None or len(boxes) == 0:
            continue
        corners = boxes_to_corners_3d(boxes[:, :7].astype(np.float32))
        for c in corners:
            ls = open3d.geometry.LineSet()
            ls.points = open3d.utility.Vector3dVector(c)
            ls.lines = open3d.utility.Vector2iVector(_BOX_EDGES)
            ls.paint_uniform_color(color)
            geoms.append(ls)
    return geoms


def draw_scenes(points, gt_boxes=None, ref_boxes=None, ref_labels=None,
                ref_scores=None, class_names=None, point_colors=None,
                draw_origin=True, highlight_in_box=True, show_iou=True,
                out_png=None, elev=28.0, azim=-150.0, backend="auto"):
    """Render one scene: points + GT (magenta) + predictions (blue)
    (reference draw_scenes across all three visual_utils modules).

    backend: "auto" (open3d if importable, else matplotlib PNG),
             "open3d" (returns the geometry list; raises without open3d),
             "mpl" (always renders a PNG; returns the output path).
    """
    points = np.asarray(points, np.float32)
    if backend == "auto":
        try:
            import open3d  # noqa: F401

            backend = "open3d"
        except ImportError:
            backend = "mpl"
    if backend == "open3d":
        return _open3d_geometries(points, gt_boxes, ref_boxes, point_colors)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(12, 12))
    ax = fig.add_subplot(projection="3d", computed_zorder=False)
    ax.set_facecolor("black")
    fig.patch.set_facecolor("black")

    colors = (np.asarray(point_colors, np.float32)
              if point_colors is not None else gradient_point_colors(points))
    # highlight points inside predicted boxes in red (reference
    # draw_point_in_box3d, open3d_vis_utils.py:139-164)
    if highlight_in_box and ref_boxes is not None and len(ref_boxes):
        inside = points_in_boxes(points[:, :3],
                                 ref_boxes[:, :7].astype(np.float32))
        colors = np.where(inside.any(axis=1)[:, None],
                          np.array([[1.0, 0.0, 0.0]], np.float32), colors)
    ax.scatter(points[:, 0], points[:, 1], points[:, 2], s=0.3, c=colors,
               depthshade=False)

    _draw_grid(ax)
    if draw_origin:  # axis triad at the sensor origin
        for vec, col in (((3, 0, 0), "r"), ((0, 3, 0), "g"), ((0, 0, 3), "b")):
            ax.plot([0, vec[0]], [0, vec[1]], [0, vec[2]], color=col,
                    linewidth=1.5)

    if gt_boxes is not None and len(gt_boxes):
        gt = np.asarray(gt_boxes, np.float32)
        _draw_corners3d(ax, boxes_to_corners_3d(gt[:, :7]), GT_COLOR)
    if ref_boxes is not None and len(ref_boxes):
        rb = np.asarray(ref_boxes, np.float32)
        ious = (calculate_iou(rb, np.asarray(gt_boxes, np.float32))
                if show_iou and gt_boxes is not None and len(gt_boxes)
                else None)
        _draw_corners3d(ax, boxes_to_corners_3d(rb[:, :7]), PRED_COLOR,
                        labels=ref_labels, scores=ref_scores, ious=ious,
                        class_names=class_names)

    lim = max(np.abs(points[:, :2]).max() if len(points) else 40.0, 10.0)
    ax.set_xlim(-lim, lim)
    ax.set_ylim(-lim, lim)
    ax.set_zlim(-2, 8)
    ax.set_box_aspect((1, 1, 0.15))
    ax.view_init(elev=elev, azim=azim)
    ax.set_axis_off()

    out_png = out_png or "scene.png"
    fig.savefig(out_png, dpi=120, bbox_inches="tight",
                facecolor=fig.get_facecolor())
    plt.close(fig)
    return out_png
