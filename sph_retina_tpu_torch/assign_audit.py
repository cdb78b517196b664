"""Assignment-quality audit: what supervision each IoU backend produces.

    python -m sph_retina_tpu_torch.assign_audit [--out work_dirs/torch_assign_audit] \\
        [--data-root work_dirs/sphere_bench] [--split train] \\
        [--config configs/sph_retinanet_r18_fpn_24e_spherebench.py] \\
        [--backends sph2pob_efficient sph2pob_efficient_jnp sph fov] \\
        [--batch 8] [--stratum polar|seam|body] [--quick] [--device cuda|cpu]

Sphere-bench's ground truth against the real anchor grid of the config,
through the real training assignment path
(``models/single_stage._batch_pairwise_iou`` + ``MaxIoUAssigner``: for
``sph2pob_efficient`` one launch of the fused pairwise kernel a batch), and
each backend's assignment against the one the exact oracle (the unbiased
IoU) gives:

- positives a GT (assigned, and the plain >= pos_thr count) — density;
- the oracle IoU of the anchors a backend marks positive — quality
  (histogram, mean, share below 0.3 / 0.4 / 0.5);
- the 3x3 ignore / negative / positive confusion against the oracle's
  assignment, and how many shared positives go to the same GT;
- on the (GT, anchor) pairs whose oracle IoU lies in [0.3, 0.7], the signed
  backend-minus-oracle error and the crossings of the two thresholds.

``sph2pob_efficient_jnp`` keeps the JAX tool's key, so that the reports
compare key for key; here it is the unfused plain PyTorch Sph2Pob
(``iou/api.py:sph_overlaps(..., "sph2pob_efficient")``), never the kernel:
the two differ by up to 4.7e-5 at D=4. The oracle's overlaps are computed
once a batch and kept on the device for every backend. Counts are summed
exactly (int64), IoU sums in float64.

Writes ``audit.json`` (the JAX tool's layout) and ``ASSIGN_AUDIT.md``; prints
each backend's row and its seconds. ``--quick``: the first 16 images.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from .engine.zoo import get_family
from .iou.api import canonical_backend, sph_overlaps
from .models.single_stage import _batch_pairwise_iou
from .utils.config import apply_overrides, load_config
from .utils.device import resolve_device, synchronize

DEFAULT_BACKENDS = ("sph2pob_efficient", "sph2pob_efficient_jnp", "sph",
                    "fov")
ORACLE = "unbiased"
BAND = (0.3, 0.7)
HIST_EDGES = np.linspace(0.0, 1.0, 21)
BELOW = (0.3, 0.4, 0.5)
QUICK_IMAGES = 16


def load_gt(ann_file, max_gt=None, stratum=None):
    """(boxes (I, G, 4) deg padded, mask (I, G) bool) from a COCO-sph json.

    ``stratum``: keep only images tagged with it ('polar'/'seam'), or only
    untagged images for 'body' (sphere-bench strata tags)."""
    with open(ann_file) as f:
        coco = json.load(f)
    keep = set()
    for im in coco["images"]:
        tags = im.get("strata", ())
        if (stratum is None or (stratum == "body" and not tags)
                or (stratum in tags)):
            keep.add(im["id"])
    per_img = {im["id"]: [] for im in coco["images"] if im["id"] in keep}
    for a in coco["annotations"]:
        if not a.get("iscrowd", 0) and a["image_id"] in per_img:
            per_img[a["image_id"]].append(a["bbox"][:4])
    gmax = max_gt or max(len(v) for v in per_img.values())
    n = len(per_img)
    boxes = np.zeros((n, gmax, 4), np.float32)
    mask = np.zeros((n, gmax), bool)
    for i, (_, bs) in enumerate(sorted(per_img.items())):
        bs = bs[:gmax]
        if bs:
            boxes[i, : len(bs)] = np.asarray(bs, np.float32)
            mask[i, : len(bs)] = True
    return boxes, mask


def pairwise(gt, anchors, backend):
    """(B, G, 4) x (N, 4) -> (B, G, N) through the training path."""
    if backend == "sph2pob_efficient_jnp":
        b, g, d = gt.shape
        iou = sph_overlaps(gt.reshape(b * g, d), anchors, "sph2pob_efficient")
        return iou.reshape(b, g, anchors.shape[0])
    return _batch_pairwise_iou(gt, anchors, backend)


def _count(x) -> torch.Tensor:
    return x.sum(dtype=torch.int64)


def make_audit_step(assigner, anchors, backend):
    """``step(gt_boxes, gt_mask, img_valid, ov_o) -> dict`` of one batch's
    sums: integer counts in int64, IoU sums in float64, on the tensors'
    device. ``ov_o``: the oracle's overlaps of the batch
    (``oracle_overlaps``)."""
    pos_thr = assigner.pos_iou_thr
    neg_thr = (assigner.neg_iou_thr if not isinstance(assigner.neg_iou_thr,
                                                      tuple)
               else assigner.neg_iou_thr[1])

    def category(gt_inds):
        # 0 = ignore, 1 = background, 2 = positive
        return torch.where(gt_inds > 0, 2, torch.where(gt_inds == 0, 1, 0))

    @torch.no_grad()
    def step(gt_boxes, gt_mask, img_valid, ov_o):
        ov = ov_o if canonical_backend(backend) == ORACLE \
            else pairwise(gt_boxes, anchors, backend)
        res = assigner(ov, gt_mask)
        res_o = assigner(ov_o, gt_mask)
        b, g, n = ov.shape
        img = img_valid[:, None]                          # (B, 1)
        gt_w = gt_mask & img                              # (B, G)

        pos = (res.gt_inds > 0) & img                     # (B, N)
        # positives per GT: assigned, and the plain >= pos_thr count
        eq = res.gt_inds[:, None, :] == torch.arange(
            1, g + 1, device=ov.device)[None, :, None]    # (B, G, N)
        pos_per_gt = eq.sum(-1) * gt_w                    # (B, G)
        thr_per_gt = (ov >= pos_thr).sum(-1) * gt_w

        # oracle IoU of the anchors this backend selected as positives
        safe = (res.gt_inds.long() - 1).clamp(0, g - 1)   # (B, N)
        oval = ov_o.gather(1, safe[:, None, :])[:, 0, :]
        bins = (oval * 20).to(torch.int32).clamp(0, 19)
        hist = torch.bincount(bins[pos].long(), minlength=20)

        # flip confusion vs the oracle assignment (3x3)
        cat = category(res.gt_inds)
        cat_o = category(res_o.gt_inds)
        conf = torch.bincount((cat * 3 + cat_o)[img.expand(-1, n)].long(),
                              minlength=9).reshape(3, 3)
        both_pos = pos & (res_o.gt_inds > 0)

        # threshold-band calibration on valid (gt, anchor) pairs
        band = (ov_o >= BAND[0]) & (ov_o <= BAND[1]) & gt_w[..., None]
        err = (ov - ov_o).double()
        crossings = {}
        for t in (neg_thr, pos_thr):
            crossings[f"promote_{t}"] = _count((ov >= t) & (ov_o < t) & band)
            crossings[f"demote_{t}"] = _count((ov < t) & (ov_o >= t) & band)

        return dict(
            pos_per_gt_sum=pos_per_gt.sum(dtype=torch.int64),
            gt_cnt=_count(gt_w),
            pos_per_gt_hist=torch.bincount(
                pos_per_gt.clamp(0, 63)[gt_w].long(), minlength=64),
            thr_per_gt_sum=thr_per_gt.sum(dtype=torch.int64),
            thr_zero_gts=_count((thr_per_gt == 0) & gt_w),
            pos_cnt=_count(pos),
            pos_oracle_sum=oval.double()[pos].sum(),
            pos_oracle_hist=hist,
            pos_below={t: _count((oval < t) & pos) for t in BELOW},
            conf=conf, same_gt=_count(both_pos
                                      & (res.gt_inds == res_o.gt_inds)),
            both_cnt=_count(both_pos),
            band_cnt=_count(band), band_err_sum=err[band].sum(),
            band_abs_sum=err.abs()[band].sum(),
            crossings=dict(sorted(crossings.items())),
            n_images=_count(img_valid),
        )

    return step


def _batches(boxes, mask, batch):
    """Host batches of ``batch`` images; the tail padded with empty images
    that ``valid`` masks, so that every batch has one shape."""
    for s in range(0, boxes.shape[0], batch):
        gb, gm = boxes[s:s + batch], mask[s:s + batch]
        valid = np.ones((gb.shape[0],), bool)
        if gb.shape[0] < batch:
            pad = batch - gb.shape[0]
            gb = np.concatenate([gb, np.zeros((pad,) + gb.shape[1:],
                                              gb.dtype)])
            gm = np.concatenate([gm, np.zeros((pad,) + gm.shape[1:], bool)])
            valid = np.concatenate([valid, np.zeros((pad,), bool)])
        yield gb, gm, valid


def _on(device, *arrays):
    return [torch.from_numpy(a).to(device) for a in arrays]


@torch.no_grad()
def oracle_overlaps(boxes, mask, anchors, batch=8) -> list:
    """The oracle's (B, G, N) overlaps of every batch, on the anchors'
    device."""
    return [pairwise(_on(anchors.device, gb)[0], anchors, ORACLE)
            for gb, _, _ in _batches(boxes, mask, batch)]


def _tree_add(a, b):
    if isinstance(a, dict):
        return {k: _tree_add(a[k], b[k]) for k in a}
    return a + b


def _tree_numpy(a):
    if isinstance(a, dict):
        return {k: _tree_numpy(v) for k, v in a.items()}
    return a.cpu().numpy()


def audit_backend(backend, boxes, mask, assigner, anchors, oracle, batch=8):
    """One backend's summary over every image. ``oracle``: the batches'
    oracle overlaps (``oracle_overlaps``)."""
    step = make_audit_step(assigner, anchors, backend)
    acc = None
    for i, (gb, gm, valid) in enumerate(_batches(boxes, mask, batch)):
        out = step(*_on(anchors.device, gb, gm, valid), oracle[i])
        acc = out if acc is None else _tree_add(acc, out)
    return summarize(_tree_numpy(acc))


def summarize(a):
    gt_cnt = max(float(a["gt_cnt"]), 1.0)
    pos_cnt = max(float(a["pos_cnt"]), 1.0)
    both = max(float(a["both_cnt"]), 1.0)
    band = max(float(a["band_cnt"]), 1.0)
    conf = a["conf"]  # rows: backend {ignore, neg, pos}; cols: oracle
    total_anchors = max(float(conf.sum()), 1.0)
    hist = a["pos_oracle_hist"]
    # quantiles of the oracle-IoU-of-positives histogram
    cum = np.cumsum(hist) / max(hist.sum(), 1.0)
    q = {p: round(float(HIST_EDGES[1:][np.searchsorted(cum, p)]), 3)
         for p in (0.1, 0.5, 0.9)}
    ppg_hist = a["pos_per_gt_hist"]
    ppg_cum = np.cumsum(ppg_hist) / max(ppg_hist.sum(), 1.0)
    ppg_q = {p: int(np.searchsorted(ppg_cum, p)) for p in (0.1, 0.5, 0.9)}
    return {
        "n_images": int(a["n_images"]),
        "n_gts": int(a["gt_cnt"]),
        "pos_per_gt_mean": round(float(a["pos_per_gt_sum"]) / gt_cnt, 2),
        "pos_per_gt_p10_p50_p90": [ppg_q[0.1], ppg_q[0.5], ppg_q[0.9]],
        "thr_pos_per_gt_mean": round(float(a["thr_per_gt_sum"]) / gt_cnt, 2),
        "gt_frac_zero_thr_pos": round(float(a["thr_zero_gts"]) / gt_cnt, 4),
        "pos_total": int(a["pos_cnt"]),
        "pos_oracle_iou_mean": round(float(a["pos_oracle_sum"]) / pos_cnt, 4),
        "pos_oracle_iou_p10_p50_p90": [q[0.1], q[0.5], q[0.9]],
        "pos_frac_oracle_below": {
            str(t): round(float(a["pos_below"][t]) / pos_cnt, 4)
            for t in BELOW},
        "flip_confusion_vs_unbiased": {
            "backend_rows_oracle_cols_ignore_neg_pos":
                [[int(x) for x in row] for row in conf],
            "anchor_category_flip_rate": round(
                float(total_anchors - np.trace(conf)) / total_anchors, 6),
            "pos_agree_same_gt_frac": round(float(a["same_gt"]) / both, 4),
            "false_pos_anchors": int(conf[2, 0] + conf[2, 1]),
            "missed_pos_anchors": int(conf[0, 2] + conf[1, 2]),
        },
        "band_calibration_oracle_0.3_0.7": {
            "n_pairs": int(a["band_cnt"]),
            "signed_err_mean": round(float(a["band_err_sum"]) / band, 4),
            "abs_err_mean": round(float(a["band_abs_sum"]) / band, 4),
            "crossings": {k: int(v) for k, v in a["crossings"].items()},
        },
    }


def write_markdown(report, path):
    b = report["backends"]
    lines = [
        "# Assignment-quality audit (sphere-bench GT x real anchor grid)",
        "",
        f"Config `{report['config']}`, split `{report['split']}`, "
        f"{report['n_images']} images, {report['n_gts']} GTs, "
        f"{report['n_anchors']} anchors; oracle = unbiased IoU; assigner "
        f"pos/neg thresholds {report['pos_iou_thr']}/{report['neg_iou_thr']}.",
        "",
        "| backend | pos/GT | >=thr pos/GT | oracle IoU of pos (mean) "
        "| pos with oracle<0.4 | cat flip rate | same-GT agree "
        "| band signed err |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for name, s in b.items():
        f = s["flip_confusion_vs_unbiased"]
        c = s["band_calibration_oracle_0.3_0.7"]
        lines.append(
            f"| {name} | {s['pos_per_gt_mean']} | {s['thr_pos_per_gt_mean']}"
            f" | {s['pos_oracle_iou_mean']} "
            f"| {s['pos_frac_oracle_below']['0.4']:.3f} "
            f"| {f['anchor_category_flip_rate']:.4f} "
            f"| {f['pos_agree_same_gt_frac']:.3f} "
            f"| {c['signed_err_mean']:+.4f} |")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def run_audit(*, data_root, out_dir, config, split="train",
              backends=DEFAULT_BACKENDS, batch=8, device=None,
              max_images=None, extra_overrides=(), stratum=None):
    """Audit ``backends`` on ``data_root``'s split, on ``device`` (the CUDA
    device unless ``"cpu"``); writes and returns the report."""
    device = resolve_device(device)
    ann = os.path.join(data_root, "annotations",
                       f"instances_{split}.json")
    with open(ann) as f:
        ncls = len(json.load(f)["categories"])
    cfg = apply_overrides(load_config(config),
                          [f"model.num_classes={ncls}", *extra_overrides])
    with torch.device("meta"):  # the detector config; no weights needed
        _, det_cfg = get_family(cfg).build(cfg)
    anchors = det_cfg.flat_anchors(device).contiguous()
    boxes, mask = load_gt(ann, stratum=stratum)
    if max_images:
        boxes, mask = boxes[:max_images], mask[:max_images]

    report = {
        "config": os.path.relpath(config),
        "split": split,
        "stratum": stratum,
        "n_images": int(boxes.shape[0]),
        "n_gts": int(mask.sum()),
        "n_anchors": int(anchors.shape[0]),
        "pos_iou_thr": det_cfg.assigner.pos_iou_thr,
        "neg_iou_thr": det_cfg.assigner.neg_iou_thr,
        "oracle": ORACLE,
        "backends": {},
    }
    t0 = time.perf_counter()
    oracle = oracle_overlaps(boxes, mask, anchors, batch)
    synchronize(device)
    print(f"=== oracle ({ORACLE}) overlaps: {len(oracle)} batches "
          f"({time.perf_counter() - t0:.2f} s)")
    for bk in backends:
        print(f"=== auditing backend {bk}")
        t0 = time.perf_counter()
        s = report["backends"][bk] = audit_backend(
            bk, boxes, mask, det_cfg.assigner, anchors, oracle, batch=batch)
        seconds = time.perf_counter() - t0
        flip = s["flip_confusion_vs_unbiased"]["anchor_category_flip_rate"]
        print(f"    pos/GT={s['pos_per_gt_mean']} "
              f"oracleIoU(pos)={s['pos_oracle_iou_mean']} flip={flip} "
              f"({seconds:.2f} s)")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "audit.json"), "w") as f:
        json.dump(report, f, indent=1)
    write_markdown(report, os.path.join(out_dir, "ASSIGN_AUDIT.md"))
    print(f"wrote {out_dir}/audit.json")
    return report


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data-root", default="work_dirs/sphere_bench")
    p.add_argument("--out", default="work_dirs/torch_assign_audit")
    p.add_argument("--config",
                   default="configs/sph_retinanet_r18_fpn_24e_spherebench.py")
    p.add_argument("--split", default="train")
    p.add_argument("--backends", nargs="*", default=list(DEFAULT_BACKENDS))
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="default: the CUDA device")
    p.add_argument("--stratum", default=None,
                   choices=["polar", "seam", "body"],
                   help="restrict to images carrying this sphere-bench "
                        "stratum tag ('body' = untagged images)")
    p.add_argument("--quick", action="store_true",
                   help=f"first {QUICK_IMAGES} images only (smoke)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    run_audit(data_root=args.data_root, out_dir=args.out, config=args.config,
              split=args.split, backends=tuple(args.backends),
              batch=args.batch, device=args.device, stratum=args.stratum,
              max_images=QUICK_IMAGES if args.quick else args.max_images)
    return 0


if __name__ == "__main__":
    sys.exit(main())
