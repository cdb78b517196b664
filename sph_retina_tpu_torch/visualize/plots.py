"""Analysis plots: an IoU backend against the oracle, and curves; drawn by
``canvas.py`` (PIL), not matplotlib."""

from __future__ import annotations

import numpy as np
import torch

from .canvas import CYCLE, Axes, data_limits


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _scatter_axes(iou_a, iou_b, label_a, label_b, r) -> Axes:
    a, b = _host(iou_a), _host(iou_b)
    ax = Axes(480, 480, data_limits(b, [0.0, 1.0]),
              data_limits(a, [0.0, 1.0]), title=f"R = {r:.4f}",
              xlabel=label_b, ylabel=label_a)
    ax.scatter(b, a, CYCLE[0], radius=1, alpha=0.3)
    ax.line([0.0, 1.0], [0.0, 1.0], (255, 0, 0), dash=(4, 3))
    return ax


def plot_iou_scatter(iou_a, iou_b, label_a="backend", label_b="unbiased",
                     out_file=None):
    """Scatter of one IoU backend (y) against the oracle (x) with the
    diagonal; returns Pearson's R of the two (``np.corrcoef``, float64)."""
    r = np.corrcoef(_host(iou_a), _host(iou_b))[0, 1]
    if out_file:
        _scatter_axes(iou_a, iou_b, label_a, label_b, r).save(out_file)
    return r


def _curve_axes(xs, ys_dict, xlabel, ylabel) -> Axes:
    xs = _host(xs)
    ys = {name: _host(v) for name, v in ys_dict.items()}
    ax = Axes(600, 360, data_limits(xs), data_limits(*ys.values()),
              xlabel=xlabel, ylabel=ylabel)
    for i, (name, v) in enumerate(ys.items()):
        ax.line(xs, v, CYCLE[i % len(CYCLE)], width=2, label=name)
    ax.legend("upper right")
    return ax


def plot_curve(xs, ys_dict, xlabel="x", ylabel="y", out_file=None):
    """One line a name of ``ys_dict`` over ``xs``, with a legend."""
    if out_file:
        _curve_axes(xs, ys_dict, xlabel, ylabel).save(out_file)
