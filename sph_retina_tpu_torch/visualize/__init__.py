"""Drawing spherical boxes on equirectangular images (numpy + PIL)."""

from .sph_draw import draw_boxes, erp_box_polyline, imshow_det_bboxes

# The JAX package's visualize also exports plot_curve, plot_iou_scatter
# (plots), PerspectiveCamera (camera) and the Kent density helpers
# (kent_vis: kent_density_erp, sample_kent, plot_kent_density,
# erp_grid_directions, directions_to_erp_deg); those modules are not ported
# yet (ROADMAP).
__all__ = ["draw_boxes", "erp_box_polyline", "imshow_det_bboxes"]
