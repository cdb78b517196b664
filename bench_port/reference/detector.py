"""Plain float32 detection logic of the two configurations: anchors and
points, the box coders, max-IoU assignment, FCOS targets, the losses, SGD
with momentum, weight decay and a global-norm clip, and the predict path
(sigmoid, per-level top-k, decode, greedy rotated NMS).

Semantics of mmdet 2.x, which the Sph2Pob repository builds on
(``AnchorHead``, ``MaxIoUAssigner``, ``FCOSHead``, ``FocalLoss``,
``L1Loss``, ``multiclass_nms``), with spherical boxes in degrees and the
Sph2Pob IoU. Written for clarity, not speed: loops where the port
vectorises, one image at a time where it batches. Nothing here imports the
port.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .rotated import sph2pob_iou_loss_terms
from .sph2pob_iou import pairwise_iou

INF = 1e8
COORD_EPS = 1e-7


# --------------------------------------------------------------------------
# anchors, points, coders
# --------------------------------------------------------------------------
def featmap_sizes(img_size, strides):
    h, w = img_size
    return [(-(-h // s), -(-w // s)) for s in strides]


def level_anchors(cfg: dict, device) -> list:
    """Per level (H*W*A, D) spherical anchors in degrees: planar anchors of
    ``octave_base_scale * 2**(i/scales_per_octave) * stride`` at each ratio,
    centred on the grid's corners, converted to (theta, phi, alpha, beta)."""
    a = cfg["anchors"]
    octaves = np.array([2 ** (i / a["scales_per_octave"])
                        for i in range(a["scales_per_octave"])])
    scales = (octaves * a["octave_base_scale"]).astype(np.float32)
    ratios = np.asarray(a["ratios"], np.float32)
    out = []
    for (fh, fw), s in zip(featmap_sizes(cfg["img_size"], a["strides"]),
                           a["strides"]):
        hr = np.sqrt(ratios)
        ws = (s * (1.0 / hr)[:, None] * scales[None]).reshape(-1)
        hs = (s * hr[:, None] * scales[None]).reshape(-1)
        base = np.stack([-0.5 * ws, -0.5 * hs, 0.5 * ws, 0.5 * hs], -1)
        xx = np.tile(np.arange(fw, dtype=np.float32) * s, fh)
        yy = np.repeat(np.arange(fh, dtype=np.float32) * s, fw)
        planar = (base[None] + np.stack([xx, yy, xx, yy], -1)[:, None]
                  ).reshape(-1, 4).astype(np.float32)
        img_h, img_w = fh * s, fw * s
        x = (planar[:, 0] + planar[:, 2]) / 2.0
        y = (planar[:, 1] + planar[:, 3]) / 2.0
        sph = np.stack([x / img_w * 360.0, y / img_h * 180.0,
                        (planar[:, 2] - planar[:, 0]) / img_w * 360.0,
                        (planar[:, 3] - planar[:, 1]) / img_h * 180.0],
                       -1).astype(np.float32)
        if cfg["box_version"] == 5:
            sph = np.concatenate([sph, np.zeros_like(sph[:, :1])], -1)
        out.append(torch.from_numpy(sph).to(device))
    return out


def level_points(cfg: dict, device) -> list:
    """Per level (H*W, 2) pixel centres of the FCOS points."""
    out = []
    for (fh, fw), s in zip(featmap_sizes(cfg["img_size"], cfg["strides"]),
                           cfg["strides"]):
        ys, xs = torch.meshgrid(torch.arange(fh, device=device),
                                torch.arange(fw, device=device), indexing="ij")
        out.append(torch.stack([(xs.reshape(-1) + 0.5) * s,
                                (ys.reshape(-1) + 0.5) * s], -1).float())
    return out


def encode(anchors, gt):
    pw, ph = anchors[..., 2].clamp_min(COORD_EPS), \
        anchors[..., 3].clamp_min(COORD_EPS)
    cols = [(gt[..., 0] - anchors[..., 0]) / pw,
            (gt[..., 1] - anchors[..., 1]) / ph,
            torch.log(gt[..., 2].clamp_min(COORD_EPS) / pw),
            torch.log(gt[..., 3].clamp_min(COORD_EPS) / ph)]
    if gt.shape[-1] == 5:
        cols.append(torch.deg2rad(gt[..., 4] - anchors[..., 4]))
    return torch.stack(cols, -1)


def _clamp_boxes(boxes):
    lo = [COORD_EPS] * 4 + [-90.0 + COORD_EPS]
    hi = [360.0 - COORD_EPS] + [180.0 - COORD_EPS] * 3 + [90.0 - COORD_EPS]
    d = boxes.shape[-1]
    return torch.stack([boxes[..., i].clamp(lo[i], hi[i]) for i in range(d)],
                       -1)


def decode(anchors, deltas, wh_ratio_clip: float = 16.0 / 1000.0):
    m = abs(math.log(wh_ratio_clip))
    cols = [anchors[..., 0] + anchors[..., 2] * deltas[..., 0],
            anchors[..., 1] + anchors[..., 3] * deltas[..., 1],
            anchors[..., 2] * torch.exp(deltas[..., 2].clamp(-m, m)),
            anchors[..., 3] * torch.exp(deltas[..., 3].clamp(-m, m))]
    if deltas.shape[-1] == 5:
        cols.append(anchors[..., 4] + torch.rad2deg(deltas[..., 4]))
    return _clamp_boxes(torch.stack(cols, -1))


def distance_decode(points, dist, img_size):
    """(l, t, r, b) pixel distances from points -> degrees in the chart."""
    h, w = img_size
    sx, sy = w / 360.0, h / 180.0
    x1, y1 = points[..., 0] - dist[..., 0], points[..., 1] - dist[..., 1]
    x2, y2 = points[..., 0] + dist[..., 2], points[..., 1] + dist[..., 3]
    return _clamp_boxes(torch.stack([(x1 + x2) / 2.0 / sx, (y1 + y2) / 2.0 / sy,
                                     (x2 - x1) / sx, (y2 - y1) / sy], -1))


# --------------------------------------------------------------------------
# assignment and losses
# --------------------------------------------------------------------------
def max_iou_assign(overlaps, gt_mask, gt_labels, pos_thr, neg_thr, min_pos):
    """One image: overlaps (G, N) -> labels (N,) (-1 ignore, C background
    filled by the caller), matched gt (N,), positive and negative masks.
    Every valid gt then claims each anchor at its own best overlap, the
    later gt winning (mmdet's low-quality matching, gt_max_assign_all)."""
    g, n = overlaps.shape
    ov = torch.where(gt_mask[:, None], overlaps, 0.0)
    max_ov, argmax = ov.max(dim=0)
    assigned = torch.full((n,), -1, dtype=torch.int64, device=ov.device)
    assigned[(max_ov >= 0) & (max_ov < neg_thr)] = 0
    pos = max_ov >= pos_thr
    assigned[pos] = argmax[pos] + 1
    gt_max = ov.max(dim=1).values
    for i in range(g):
        if bool(gt_mask[i]) and float(gt_max[i]) >= min_pos:
            assigned[ov[i] == gt_max[i]] = i + 1
    matched = (assigned - 1).clamp(min=0)
    return assigned > 0, assigned == 0, matched


def sigmoid_focal(logits, target_onehot, gamma=2.0, alpha=0.25):
    p = torch.sigmoid(logits)
    t = target_onehot
    pt = (1 - p) * t + p * (1 - t)
    w = (alpha * t + (1 - alpha) * (1 - t)) * pt.pow(gamma)
    bce = logits.clamp_min(0) - logits * t + torch.log1p(torch.exp(-logits.abs()))
    return bce * w


def onehot(labels, num_classes):
    """labels (N,) in [0, C]; C is background, a row of zeros."""
    return (labels[:, None] == torch.arange(num_classes,
                                            device=labels.device)).float()


def retina_targets(cfg, anchors, gt_boxes, gt_labels, gt_mask):
    """Per image: labels, label weights, regression targets and weights."""
    out = []
    a = cfg["assigner"]
    for b in range(gt_boxes.shape[0]):
        ov = pairwise_iou(gt_boxes[b].float().contiguous(), anchors)
        pos, neg, matched = max_iou_assign(ov, gt_mask[b], gt_labels[b],
                                           a["pos_iou_thr"], a["neg_iou_thr"],
                                           a["min_pos_iou"])
        labels = torch.where(pos, gt_labels[b].long()[matched],
                             cfg["num_classes"])
        tgt = encode(anchors, gt_boxes[b].float()[matched])
        out.append(dict(labels=labels, label_w=(pos | neg).float(),
                        tgt=torch.where(pos[:, None], tgt, 0.0),
                        box_w=pos.float()))
    return out


def retina_loss_sums(cfg, cls, reg, targets):
    """Sums (not yet normalised) of the focal and L1 terms of the images
    of ``targets`` against their outputs (B_chunk, N, C|D)."""
    focal = l1 = 0.0
    for b, t in enumerate(targets):
        f = sigmoid_focal(cls[b], onehot(t["labels"], cfg["num_classes"]))
        focal = focal + (f * t["label_w"][:, None]).sum()
        l1 = l1 + ((reg[b] - t["tgt"]).abs() * t["box_w"][:, None]).sum()
    return {"loss_cls": focal, "loss_bbox": l1}


def fcos_targets(cfg, points, gt_boxes, gt_labels, gt_mask):
    """Per image: labels, (l, t, r, b) targets and centerness; the gt of
    least area that holds the point inside the level's regress range."""
    ranges = cfg["regress_ranges"]
    pts = torch.cat(points)
    rr = torch.cat([torch.tensor([lo, hi], dtype=torch.float32,
                                 device=pts.device).expand(len(p), 2)
                    for p, (lo, hi) in zip(points, ranges)])
    h, w = cfg["img_size"]
    sx, sy = w / 360.0, h / 180.0
    out = []
    for b in range(gt_boxes.shape[0]):
        g = gt_boxes[b].float()
        x1 = g[:, 0] * sx - g[:, 2] * sx / 2
        y1 = g[:, 1] * sy - g[:, 3] * sy / 2
        x2 = g[:, 0] * sx + g[:, 2] * sx / 2
        y2 = g[:, 1] * sy + g[:, 3] * sy / 2
        area = (x2 - x1) * (y2 - y1)
        d = torch.stack([pts[:, :1] - x1, pts[:, 1:] - y1,
                         x2 - pts[:, :1], y2 - pts[:, 1:]], -1)  # (P, G, 4)
        inside = d.amin(-1) > 0
        dmax = d.amax(-1)
        in_range = (dmax >= rr[:, :1]) & (dmax <= rr[:, 1:])
        cand = torch.where(inside & in_range & gt_mask[b][None],
                           area[None], INF)
        best = cand.argmin(-1)
        pos = cand.gather(1, best[:, None])[:, 0] < INF
        labels = torch.where(pos, gt_labels[b].long()[best], cfg["num_classes"])
        tgt = d[torch.arange(len(pts), device=pts.device), best]
        lr = tgt[:, [0, 2]]
        tb = tgt[:, [1, 3]]
        ctr = torch.sqrt(torch.clamp(
            lr.amin(-1) / lr.amax(-1).clamp_min(1e-6)
            * tb.amin(-1) / tb.amax(-1).clamp_min(1e-6), 0.0, 1.0))
        out.append(dict(labels=labels, pos=pos, tgt=tgt,
                        ctr=torch.where(pos, ctr, 0.0)))
    return out


def fcos_loss_sums(cfg, cls, reg, ctr, points, targets):
    """Unnormalised sums of the focal, Sph2Pob IoU and centerness terms."""
    pts = torch.cat(points)
    focal = iou = cbce = 0.0
    for b, t in enumerate(targets):
        focal = focal + sigmoid_focal(
            cls[b], onehot(t["labels"], cfg["num_classes"])).sum()
        p = t["pos"]
        if bool(p.any()):
            pred = distance_decode(pts[p], reg[b][p][:, :4], cfg["img_size"])
            tgt = distance_decode(pts[p], t["tgt"][p], cfg["img_size"])
            iou = iou + (sph2pob_iou_loss_terms(pred, tgt) * t["ctr"][p]).sum()
            x, y = ctr[b][p], t["ctr"][p]
            cbce = cbce + (x.clamp_min(0) - x * y
                           + torch.log1p(torch.exp(-x.abs()))).sum()
    return {"loss_cls": focal, "loss_bbox": iou, "loss_centerness": cbce}


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------
def lr_at(cfg: dict, count: int) -> float:
    """Linear warm-up, in float32 as the configs' schedule computes it."""
    o = cfg["optimizer"]
    f32 = np.float32
    if count < o["warmup_iters"]:
        ramp = f32(1.0 - o["warmup_ratio"]) * f32(count) / f32(o["warmup_iters"])
        return float(f32(o["lr"]) * (f32(o["warmup_ratio"]) + ramp))
    return float(o["lr"])


def trainable(cfg: dict, name: str) -> bool:
    return not any(name.replace(".", "/").startswith(p)
                   for p in cfg["optimizer"]["frozen_prefixes"])


def train_steps(cfg: dict, model, batches, chunk: int = 4,
                collect=None):
    """``len(batches)`` SGD steps of ``model`` (float32, in place). Each
    batch's loss normalisers are taken over the whole batch first; the
    gradient is then accumulated ``chunk`` images at a time. Returns each
    step's losses as floats, and each step's global gradient norm before
    the clip; ``collect(step, grads, params)`` is called after
    each step with the clipped gradients (``grads``, before decay and
    momentum) of the trainable parameters by name."""
    o = cfg["optimizer"]
    params = {n: p for n, p in model.named_parameters() if trainable(cfg, n)}
    for n, p in model.named_parameters():
        p.requires_grad_(n in params)
    bufs = {n: torch.zeros_like(p) for n, p in params.items()}
    device = next(model.parameters()).device
    if cfg["family"] == "retinanet":
        anchors = torch.cat(level_anchors(cfg, device))
    else:
        points = level_points(cfg, device)
    history, norms = [], []
    for step, batch in enumerate(batches):
        gt = [batch[k] for k in ("gt_boxes", "gt_labels", "gt_mask")]
        with torch.no_grad():
            if cfg["family"] == "retinanet":
                targets = retina_targets(cfg, anchors, *gt)
                norm = {"loss_cls": max(sum(float(t["box_w"].sum())
                                            for t in targets), 1.0)}
                norm["loss_bbox"] = norm["loss_cls"]
            else:
                targets = fcos_targets(cfg, points, *gt)
                n_pos = max(sum(float(t["pos"].sum()) for t in targets), 1.0)
                ctr_sum = max(sum(float(t["ctr"].sum()) for t in targets), 1e-6)
                norm = {"loss_cls": n_pos, "loss_bbox": ctr_sum,
                        "loss_centerness": n_pos}
        for p in params.values():
            p.grad = None
        losses = {k: 0.0 for k in norm}
        n = batch["images"].shape[0]
        for i in range(0, n, chunk):
            out = model(batch["images"][i:i + chunk])
            heads = [torch.cat(list(o_), 1) for o_ in out]
            tchunk = targets[i:i + chunk]
            if cfg["family"] == "retinanet":
                sums = retina_loss_sums(cfg, heads[0], heads[1], tchunk)
            else:
                sums = fcos_loss_sums(cfg, *heads, points, tchunk)
            total = sum(v / norm[k] for k, v in sums.items())
            total.backward()
            for k, v in sums.items():
                losses[k] += float(v.detach()) / norm[k]
        losses["loss"] = sum(losses.values())
        history.append(losses)
        with torch.no_grad():
            grads = {k: p.grad for k, p in params.items()}
            gnorm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads.values()))
            clip = o["grad_clip"]
            scale = 1.0 if float(gnorm) < clip else clip / float(gnorm)
            norms.append(float(gnorm))
            grads = {k: g * scale for k, g in grads.items()}
            if collect is not None:
                collect(step, grads, params)
            lr = lr_at(cfg, step)
            for k, p in params.items():
                bufs[k].mul_(o["momentum"]).add_(
                    grads[k] + o["weight_decay"] * p)
                p.sub_(lr * bufs[k])
    return history, norms


# --------------------------------------------------------------------------
# predict
# --------------------------------------------------------------------------
def greedy_nms(iou: np.ndarray, labels: np.ndarray, thr: float) -> np.ndarray:
    """Boxes in score order; a box is kept unless a kept box of its class
    before it overlaps it by more than ``thr``."""
    keep = np.zeros(len(labels), bool)
    suppressed = np.zeros(len(labels), bool)
    for i in range(len(labels)):
        if suppressed[i]:
            continue
        keep[i] = True
        suppressed |= (iou[i] > thr) & (labels == labels[i])
    return keep


def retina_detect(cfg: dict, cls, reg, anchors) -> dict:
    """One image's detections from per-level (N_l, C) logits and (N_l, D)
    deltas: sigmoid, scores over ``score_thr`` per level, the level's top
    ``nms_pre`` (anchor, class) pairs, decode, the ``nms_pre`` best over all
    levels (``candidates``), greedy per-class NMS at ``iou_threshold`` with
    the Sph2Pob IoU, the ``max_per_img`` best kept (``kept``). Each is
    (boxes (K, D), scores (K,), labels (K,)) as numpy, best first."""
    t = cfg["test"]
    tops, labs, boxes = [], [], []
    for c, r, a in zip(cls, reg, anchors):
        s = torch.sigmoid(c.float())
        flat = torch.where(s > t["score_thr"], s, -1.0).reshape(-1)
        k = min(t["nms_pre"], flat.numel())
        top, idx = torch.topk(flat, k)
        keep = top > 0
        top, idx = top[keep], idx[keep]
        anchor = idx // c.shape[1]
        tops.append(top)
        labs.append(idx % c.shape[1])
        boxes.append(decode(a[anchor], r[anchor].float()))
    top, lab, box = torch.cat(tops), torch.cat(labs), torch.cat(boxes)
    order = torch.sort(top, descending=True, stable=True).indices[:t["nms_pre"]]
    top, lab, box = top[order], lab[order], box[order]
    iou = pairwise_iou(box.contiguous(), box.contiguous()).cpu().numpy()
    cand = (box.cpu().numpy(), top.cpu().numpy(), lab.cpu().numpy())
    keep = greedy_nms(iou, cand[2], t["iou_threshold"])
    sel = np.flatnonzero(keep)[:t["max_per_img"]]
    return {"kept": tuple(x[sel] for x in cand), "candidates": cand}


@torch.no_grad()
def detect_batch(cfg: dict, model, frames_u8: torch.Tensor, anchors,
                 chunk: int = 4) -> list:
    """``retina_detect`` of every frame of (B, H, W, 3) uint8, the network
    run ``chunk`` frames at a time."""
    out = []
    for i in range(0, frames_u8.shape[0], chunk):
        cls, reg = model(frames_u8[i:i + chunk])
        for b in range(cls[0].shape[0]):
            out.append(retina_detect(cfg, [c[b] for c in cls],
                                     [r[b] for r in reg], anchors))
    return out
