"""Drawing spherical boxes, perspective views, Kent densities and analysis
plots; every figure is drawn by ``canvas.py`` (PIL), none by matplotlib."""

from .sph_draw import draw_boxes, erp_box_polyline, imshow_det_bboxes
from .plots import plot_curve, plot_iou_scatter
from .camera import PerspectiveCamera
from .kent_vis import (
    directions_to_erp_deg,
    erp_grid_directions,
    kent_density_erp,
    plot_kent_density,
    sample_kent,
)

__all__ = ["draw_boxes", "erp_box_polyline", "imshow_det_bboxes",
           "plot_curve", "plot_iou_scatter", "PerspectiveCamera",
           "kent_density_erp", "sample_kent", "plot_kent_density",
           "erp_grid_directions", "directions_to_erp_deg"]
