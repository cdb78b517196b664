"""Directional AP-parity study on the sphere-bench synthetic benchmark.

    python -m sph_retina_tpu_torch.ap_study [--out work_dirs/torch_ap_study] \\
        [--data-root DIR] [--seeds 0 1 ..] [--max-epochs N] [--quick] \\
        [--families retinanet fcos ssd faster_rcnn rbfov] [--box-version 4|5] \\
        [--merge-with report.json] [--device cuda|cpu]

The reference paper's ablations order two axes on 360-Indoor: the loss
(Sph2Pob-CIoU over the L1 baseline) and the assignment (Sph2Pob over the
approximate ``sph`` / ``fov`` IoUs). This study reproduces the directions
on sphere-bench (``synth_dataset.py``), whose footprints are painted with
the unbiased IoU's inside test: each variant trains a tracked config with
dotted overrides (recorded in the report), same seed and budget, in one
process on one device, then is evaluated on the val split with the
unbiased oracle as the matcher, overall and by image stratum (polar / seam
/ body). A variant whose loss turns NaN is recorded as diverged.

Writes ``report.json`` and ``AP_STUDY.md`` in the JAX tool's layout, and
each run's raw detections ``<out>/<variant>_s<seed>/eval_arrays.npz`` (for
``detection_diagnosis``). The dataset is generated at ``--data-root`` where
its last images are missing (``work_dirs/sphere_bench`` by default, whose
committed annotations the published parameters reproduce byte for byte;
with ``--quick`` and no ``--data-root``, under ``<out>/sphere_bench``); an
annotation file there with other bytes is never replaced (the writer
raises). ``--quick``: 24 / 12 images, 4 classes, 128x256, 2 epochs.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

import numpy as np
import torch

from .data import to_device
from .data.loader import PinnedStaging
from .engine.builder import build_datasets, build_tx
from .engine.eval import eval_spherical_map
from .engine.evaluator import evaluate_dataset
from .engine.runner import MetricLogger, run_training
from .engine.zoo import get_family, make_generic_train_step
from .synth_dataset import VAL_SEED_OFFSET, write_sphere_bench
from .utils.config import apply_overrides, load_config
from .utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_DATA_ROOT = "work_dirs/sphere_bench"

# (name, dotted cfg overrides) — applied to the tracked base config.
# `ciou` IS the base config; listed with empty overrides for the record.
VARIANTS = [
    ("l1", [
        "model.reg_decoded_bbox=False",
        "model.loss_bbox={'type': 'SphL1Loss', 'loss_weight': 1.0}",
    ]),
    ("ciou", []),
    ("assign_sph", [
        "train_cfg.assigner.backend=sph",
    ]),
    ("assign_fov", [
        "train_cfg.assigner.backend=fov",
    ]),
    # control arm: the exact unbiased oracle as the training assigner
    ("assign_unbiased", [
        "train_cfg.assigner.backend=unbiased",
    ]),
    # the Kent pipeline (KLD-IoU assignment, Kent KLD loss on decoded
    # boxes); at this study's batch 8 the base lr diverges, so the variant
    # runs at lr/4 with a small loss weight
    ("kent", [
        "model.loss_bbox={'type': 'KentLoss', 'loss_weight': 0.1}",
        "train_cfg.assigner.backend=kent",
        "optimizer.lr=0.0025",
    ]),
]

# Detector-family axis: each family has its own tracked spherebench config
# whose default IS the ciou variant; `l1` reverts to the family's stock
# regression. The assignment axis is studied on RetinaNet only.
FAMILY_CONFIGS = {
    "retinanet": "sph_retinanet_r18_fpn_24e_spherebench.py",
    "fcos": "sph_fcos_r18_fpn_24e_spherebench.py",
    "ssd": "sph_ssd_24e_spherebench.py",
    "faster_rcnn": "sph_faster_rcnn_r18_fpn_24e_spherebench.py",
    # RBFoV (box_version=5): run with --box-version 5 and a separate
    # --data-root / --out
    "rbfov": "sph_rotated_retinanet_r18_24e_spherebench.py",
}
FAMILY_VARIANTS = {
    "retinanet": VARIANTS,
    # FCOS has no delta parameterisation; its L1 baseline regresses decoded
    # coordinates, with Smooth-L1 and a lower lr (plain L1 on exp-decoded
    # distances diverges)
    "fcos": [
        ("l1", [
            "model.loss_bbox={'type': 'SmoothL1Loss', 'beta': 5.0, "
            "'loss_weight': 0.05}",
            "optimizer.lr=0.005",
        ]),
        ("ciou", []),
    ],
    "ssd": [
        ("l1", ["model.reg_decoded_bbox=False"]),
        ("ciou", []),
    ],
    "faster_rcnn": [
        ("l1", ["model.reg_decoded_bbox=False"]),
        ("ciou", []),
    ],
    "rbfov": [
        ("l1", [
            "model.reg_decoded_bbox=False",
            "model.loss_bbox={'type': 'SphL1Loss', 'loss_weight': 1.0}",
        ]),
        ("ciou", []),
    ],
}

STRATA = ("polar", "seam", "body")
QUICK_DATASET = dict(n_train=24, n_val=12, num_classes=4, img_size=(128, 256))
FULL_DATASET = dict(n_train=500, n_val=100, num_classes=12,
                    img_size=(256, 512))


def _arrays_to_lists(arrays, idx):
    """Per-image (dets, annotations) lists from evaluator raw arrays."""
    det_results, annotations = [], []
    for i in idx:
        v = arrays["valid"][i]
        det_results.append((arrays["boxes"][i][v], arrays["scores"][i][v],
                            arrays["labels"][i][v]))
        m = arrays["gt_mask"][i]
        im = arrays["ig_mask"][i]
        annotations.append({
            "boxes": arrays["gt_boxes"][i][m],
            "labels": arrays["gt_labels"][i][m],
            "ignore_boxes": arrays["ig_boxes"][i][im],
            "ignore_labels": arrays["ig_labels"][i][im],
        })
    return det_results, annotations


def stratified_metrics(arrays, strata_by_img, num_classes,
                       backend="unbiased", device=None):
    """AP per image stratum. An image counts toward every tag it carries;
    untagged images form the 'body' stratum. The matcher's IoUs run on
    ``device`` (``None``: the CUDA device)."""
    img_ids = arrays["img_id"]
    out = {}
    for stratum in STRATA:
        if stratum == "body":
            keep = [i for i, g in enumerate(img_ids)
                    if not strata_by_img.get(int(g))]
        else:
            keep = [i for i, g in enumerate(img_ids)
                    if stratum in strata_by_img.get(int(g), ())]
        if not keep:
            continue
        dets, anns = _arrays_to_lists(arrays, keep)
        m = eval_spherical_map(dets, anns, num_classes, backend=backend,
                               device=device)
        out[stratum] = {"AP50": m["AP50"], "mAP": m["mAP"],
                        "n_images": len(keep)}
    return out


def train_variant(cfg, *, seed, work_dir, max_epochs=None, device=None):
    """One process trains the config to completion on ``device``; returns
    (model, detector config, family, training seconds). A NaN loss at a
    log step raises ``FloatingPointError``."""
    device = resolve_device(device)
    family = get_family(cfg)
    model, det_cfg = family.build(cfg)
    ds, loader = build_datasets(cfg, "train")
    if ds.num_classes != cfg["model"]["num_classes"]:
        raise ValueError(f"dataset has {ds.num_classes} classes, config "
                         f"says {cfg['model']['num_classes']}")
    max_epochs = max_epochs or cfg.get("runner", {}).get("max_epochs", 24)
    model.init_weights(torch.Generator().manual_seed(seed))
    model = model.to(device)
    optimizer = build_tx(cfg, model, steps_per_epoch=max(len(loader), 1))
    step = make_generic_train_step(family, model, det_cfg, optimizer,
                                   seed=seed)
    staging = PinnedStaging() if device.type == "cuda" else None
    logger = MetricLogger(work_dir, enabled=True,
                          interval=cfg.get("log_config", {}).get("interval", 20))
    t0 = time.time()
    try:
        run_training(
            train_step=step, optimizer=optimizer, loader=loader,
            max_epochs=max_epochs, logger=logger,
            transfer=lambda b: to_device(
                {k: v for k, v in b.items() if k != "img_id"}, device,
                staging),
            model=model, device=device)
    finally:
        logger.close()
    return model, det_cfg, family, time.time() - t0


def eval_variant(cfg, model, det_cfg, family, strata_by_img,
                 backend="unbiased", work_dir=None):
    """AP50, mAP, AP75 on the val split (matched by ``backend``) and by
    stratum; the raw arrays saved to ``work_dir/eval_arrays.npz``."""
    _, val_loader = build_datasets(cfg, "val")
    metrics, arrays = evaluate_dataset(
        model, det_cfg, val_loader, backend=backend,
        predict=family.predict_fn(model, det_cfg), return_raw=True)
    if work_dir:
        # raw detections + GT per image, for detection_diagnosis
        np.savez_compressed(os.path.join(work_dir, "eval_arrays.npz"),
                            **arrays)
    strat = stratified_metrics(arrays, strata_by_img,
                               cfg["model"]["num_classes"], backend=backend,
                               device=next(model.parameters()).device)
    return {"AP50": metrics["AP50"], "mAP": metrics["mAP"],
            "AP75": metrics["AP75"], "n_images": metrics["n_images"],
            "strata": strat}


def load_strata(ann_file):
    with open(ann_file) as f:
        coco = json.load(f)
    return {im["id"]: tuple(im.get("strata", ())) for im in coco["images"]}


def ensure_dataset(root, *, n_train, n_val, num_classes, img_size, seed,
                   box_version=4):
    """The splits' annotation files, generated where they or the last image
    of a split are missing (a fresh clone has the committed annotations and
    no images; an interrupted generation lacks its last images). An
    annotation file with other bytes than these parameters give raises
    ``FileExistsError`` and is left as it is."""
    train_ann = os.path.join(root, "annotations", "instances_train.json")
    val_ann = os.path.join(root, "annotations", "instances_val.json")
    last_imgs = [os.path.join(root, "images", f"train_{n_train:05d}.png"),
                 os.path.join(root, "images", f"val_{n_val:05d}.png")]
    if (not (os.path.exists(train_ann) and os.path.exists(val_ann))
            or not all(os.path.exists(p) for p in last_imgs)):
        print(f"generating sphere-bench at {root} "
              f"({n_train}+{n_val} images, {num_classes} classes, "
              f"box_version {box_version})")
        write_sphere_bench(root, split="train", n_images=n_train,
                           num_classes=num_classes, img_size=img_size,
                           box_version=box_version, seed=seed)
        write_sphere_bench(root, split="val", n_images=n_val,
                           num_classes=num_classes, img_size=img_size,
                           box_version=box_version,
                           seed=seed + VAL_SEED_OFFSET)
    return train_ann, val_ann


def _run_variants(cfg_path, variant_list, *, data_overrides, seeds,
                  max_epochs, out_dir, strata_by_img, prefix="",
                  device=None):
    results = {}
    for name, overrides in variant_list:
        results[name] = {"overrides": overrides, "seeds": {}}
        for seed in seeds:
            cfg = apply_overrides(load_config(cfg_path),
                                  data_overrides + list(overrides))
            cfg["seed"] = seed
            wd = os.path.join(out_dir, f"{prefix}{name}_s{seed}")
            os.makedirs(wd, exist_ok=True)
            print(f"=== {prefix}{name} seed={seed} -> {wd}")
            try:
                model, det_cfg, family, train_s = train_variant(
                    cfg, seed=seed, work_dir=wd, max_epochs=max_epochs,
                    device=device)
                m = eval_variant(cfg, model, det_cfg, family,
                                 strata_by_img, work_dir=wd)
            except FloatingPointError as e:
                # one diverging variant must not end the study
                print(f"    DIVERGED: {e}")
                results[name]["seeds"][str(seed)] = {"error": str(e)}
                continue
            finally:
                model = None
                gc.collect()
                if torch.cuda.is_available():
                    torch.cuda.empty_cache()
            m["train_seconds"] = round(train_s, 1)
            results[name]["seeds"][str(seed)] = m
            print(f"    AP50={m['AP50']:.4f} mAP={m['mAP']:.4f} "
                  f"({train_s:.0f}s train)")
        ok = [s for s in results[name]["seeds"].values() if "AP50" in s]
        results[name]["AP50_mean"] = float(np.mean(
            [s["AP50"] for s in ok])) if ok else None
        results[name]["mAP_mean"] = float(np.mean(
            [s["mAP"] for s in ok])) if ok else None
    return results


def _orderings(results):
    # variants whose every seed diverged have AP50_mean None — no ordering
    results = {k: v for k, v in results.items()
               if v.get("AP50_mean") is not None}
    o = {}
    if "l1" in results and "ciou" in results:
        o["ciou_gt_l1"] = (results["ciou"]["AP50_mean"]
                           > results["l1"]["AP50_mean"])
    if "assign_sph" in results and "ciou" in results:
        o["sph2pob_assign_gt_sph_assign"] = (
            results["ciou"]["AP50_mean"]
            > results["assign_sph"]["AP50_mean"])
        if "assign_fov" in results:
            # the paper's full ordering: Sph2Pob > Fov > Sph
            o["fov_assign_gt_sph_assign"] = (
                results["assign_fov"]["AP50_mean"]
                > results["assign_sph"]["AP50_mean"])
            o["sph2pob_assign_gt_fov_assign"] = (
                results["ciou"]["AP50_mean"]
                > results["assign_fov"]["AP50_mean"])
    return o


def merge_reports(base: dict, new: dict) -> dict:
    """Union of seeds per family/variant (new wins on duplicates); means and
    orderings recomputed from the merged seed sets, so that a later seed
    sweep folds into a published report instead of replacing it."""
    out = json.loads(json.dumps(new))
    base_fams = base.get("families") or {
        "retinanet": {"base_config": base["base_config"],
                      "variants": base["variants"],
                      "orderings": base.get("orderings", {})}}
    fams = out.setdefault("families", {})
    for fam, bfr in base_fams.items():
        fr = fams.setdefault(fam, {"base_config": bfr["base_config"],
                                   "variants": {}, "orderings": {}})
        for name, bv in bfr["variants"].items():
            v = fr["variants"].setdefault(
                name, {"overrides": bv["overrides"], "seeds": {}})
            if bv["overrides"] != v["overrides"]:
                # seeds of other overrides must not enter these means
                print(f"[merge] skipping stale seeds for {fam}/{name}: "
                      f"base overrides {bv['overrides']} != "
                      f"current {v['overrides']}")
                continue
            for s, m in bv["seeds"].items():
                v["seeds"].setdefault(s, m)
    for fr in fams.values():
        for v in fr["variants"].values():
            ok = [m for m in v["seeds"].values() if "AP50" in m]
            v["AP50_mean"] = float(np.mean(
                [m["AP50"] for m in ok])) if ok else None
            v["mAP_mean"] = float(np.mean(
                [m["mAP"] for m in ok])) if ok else None
        fr["orderings"] = _orderings(fr["variants"])
    primary = "retinanet" if "retinanet" in fams else next(iter(fams))
    out["variants"] = fams[primary]["variants"]
    if fams[primary]["orderings"]:
        out["orderings"] = fams[primary]["orderings"]
    out["seeds"] = sorted({int(s) for f in fams.values()
                           for v in f["variants"].values()
                           for s in v["seeds"]})
    return out


def run_study(*, out_dir, seeds, data_root=None, max_epochs=None,
              quick=False, device=None, variants=None,
              families=("retinanet",), box_version=4, merge_with=None):
    """Train and evaluate every variant of ``families`` for each seed on
    ``device`` (the CUDA device unless ``"cpu"``); writes ``report.json`` and
    ``AP_STUDY.md`` after each family and returns the report.
    ``data_root=None``: ``<out_dir>/sphere_bench`` with ``quick``, else
    ``work_dirs/sphere_bench``."""
    device = resolve_device(device)
    if data_root is None:
        data_root = os.path.join(out_dir, "sphere_bench") if quick \
            else DEFAULT_DATA_ROOT
    os.makedirs(out_dir, exist_ok=True)
    base_report = None
    if merge_with and os.path.exists(merge_with):
        with open(merge_with) as f:
            base_report = json.load(f)
    cfg_dir = os.path.join(REPO, "configs")

    if quick:
        gen = dict(QUICK_DATASET)
        max_epochs = max_epochs or 2
    else:
        gen = dict(FULL_DATASET)
    _, val_ann = ensure_dataset(data_root, seed=0, box_version=box_version,
                                **gen)
    strata_by_img = load_strata(val_ann)

    data_overrides = [
        f"data.train.ann_file={data_root}/annotations/instances_train.json",
        f"data.train.img_prefix={data_root}/images/",
        f"data.val.ann_file={data_root}/annotations/instances_val.json",
        f"data.val.img_prefix={data_root}/images/",
        f"model.num_classes={gen['num_classes']}",
    ]
    if quick:
        data_overrides += ["img_size=(128,256)", "data.samples_per_gpu=8",
                           "lr_config.warmup_iters=10"]

    def assemble(fam_reports):
        primary = ("retinanet" if "retinanet" in fam_reports
                   else next(iter(fam_reports)))
        report = {
            "base_config": fam_reports[primary]["base_config"],
            "dataset": {"root": data_root, "box_version": box_version,
                        **{k: list(v) if isinstance(v, tuple)
                           else v for k, v in gen.items()}},
            "seeds": list(seeds),
            "max_epochs": max_epochs or 24,
            "eval_backend": "unbiased",
            # top-level keys mirror the primary (retinanet) family;
            # `families` holds every detector family studied
            "variants": fam_reports[primary]["variants"],
            "families": fam_reports,
        }
        if fam_reports[primary]["orderings"]:
            report["orderings"] = fam_reports[primary]["orderings"]
        if base_report is not None:
            report = merge_reports(base_report, report)
        return report

    path = os.path.join(out_dir, "report.json")
    fam_reports = {}
    report = None
    for fam in families:
        cfg_path = os.path.join(cfg_dir, FAMILY_CONFIGS[fam])
        variant_list = (variants if variants is not None
                        else FAMILY_VARIANTS[fam])
        prefix = "" if fam == "retinanet" else f"{fam}_"
        res = _run_variants(cfg_path, variant_list,
                            data_overrides=data_overrides, seeds=seeds,
                            max_epochs=max_epochs, out_dir=out_dir,
                            strata_by_img=strata_by_img, prefix=prefix,
                            device=device)
        fam_reports[fam] = {
            "base_config": f"configs/{FAMILY_CONFIGS[fam]}",
            "variants": res,
            "orderings": _orderings(res),
        }
        # the report after every family, so that an interrupted study
        # leaves its completed families on disk
        report = assemble(fam_reports)
        with open(path, "w") as f:
            json.dump(report, f, indent=1)
        write_markdown(report, os.path.join(out_dir, "AP_STUDY.md"))
        print(f"report checkpoint ({fam}): {path}")
    return report


def _variant_table(results):
    lines = [
        "| variant | overrides | AP50 | mAP | polar AP50 | seam AP50 | body AP50 |",
        "|---|---|---|---|---|---|---|",
    ]
    for name, v in results.items():
        def f(x):
            return "-" if x is None else f"{x:.3f}"

        if v.get("AP50_mean") is None:
            err = next(iter(v["seeds"].values())).get("error", "diverged")
            lines.append(f"| {name} | `{'; '.join(v['overrides'])}` "
                         f"| - | - | ({err}) | - | - |")
            continue
        s0 = next(s for s in v["seeds"].values() if "AP50" in s)
        st = s0.get("strata", {})
        lines.append(
            f"| {name} | `{'; '.join(v['overrides']) or '(base)'}` "
            f"| {v['AP50_mean']:.3f} | {v['mAP_mean']:.3f} "
            f"| {f(st.get('polar', {}).get('AP50'))} "
            f"| {f(st.get('seam', {}).get('AP50'))} "
            f"| {f(st.get('body', {}).get('AP50'))} |")
    return lines


def _ordering_lines(o):
    def verdict(k):
        return "reproduced" if o[k] else "NOT reproduced"

    lines = []
    if "ciou_gt_l1" in o:
        lines.append(f"- Sph2Pob-CIoU > L1 (reference README.md:53-60): "
                     f"**{verdict('ciou_gt_l1')}**")
    if "sph2pob_assign_gt_sph_assign" in o:
        lines.append(f"- sph2pob assignment > sph assignment "
                     f"(README.md:36-45): "
                     f"**{verdict('sph2pob_assign_gt_sph_assign')}**")
    if "sph2pob_assign_gt_fov_assign" in o:
        lines += [
            f"- sph2pob assignment > fov assignment (README.md:36-45): "
            f"**{verdict('sph2pob_assign_gt_fov_assign')}**",
            f"- fov assignment > sph assignment (README.md:36-45): "
            f"**{verdict('fov_assign_gt_sph_assign')}**",
        ]
    return lines


def write_markdown(report, path):
    """The study's markdown. A hand-written ROOT_CAUSE.md beside it is
    appended verbatim, so that regenerating the report never loses it."""
    lines = [
        "# AP-parity study: sphere-bench ablations",
        "",
        "Offline directional reproduction of the reference paper's 360-Indoor"
        " ablations (reference README.md:36-45,53-60) on the controlled"
        " synthetic ERP benchmark (`tools/synth_dataset.py`); real data is"
        " environment-blocked (zero egress).",
        "",
        f"Base config: `{report['base_config']}` — seeds {report['seeds']},"
        f" {report['max_epochs']} epochs each, unbiased-oracle AP matching.",
        f"Dataset: {report['dataset']}",
        "",
    ]
    lines += _variant_table(report["variants"])
    if "orderings" in report:
        lines += ["", "## Paper orderings", ""]
        lines += _ordering_lines(report["orderings"])
    for fam, fr in report.get("families", {}).items():
        if fr["variants"] == report["variants"]:
            continue  # primary family already rendered above
        lines += ["", f"## Detector family: {fam}",
                  f"Base config: `{fr['base_config']}`", ""]
        lines += _variant_table(fr["variants"])
        if fr.get("orderings"):
            lines += [""]
            lines += _ordering_lines(fr["orderings"])
    root_cause = os.path.join(os.path.dirname(path), "ROOT_CAUSE.md")
    if os.path.exists(root_cause):
        with open(root_cause) as rc:
            lines += ["", rc.read().rstrip()]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data-root", default=None,
                   help=f"default: {DEFAULT_DATA_ROOT}; with --quick, "
                        f"<out>/sphere_bench")
    p.add_argument("--out", default="work_dirs/torch_ap_study")
    p.add_argument("--seeds", type=int, nargs="*", default=[0])
    p.add_argument("--max-epochs", type=int, default=None)
    p.add_argument("--quick", action="store_true",
                   help="tiny dataset + 2 epochs (smoke; numbers are not "
                        "meaningful, only the plumbing)")
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="default: the CUDA device")
    p.add_argument("--families", nargs="*", default=["retinanet"],
                   choices=sorted(FAMILY_CONFIGS))
    p.add_argument("--box-version", type=int, default=4, choices=(4, 5),
                   help="5 generates an RBFoV dataset (use with the rbfov "
                        "family and a separate --data-root/--out)")
    p.add_argument("--merge-with", default=None,
                   help="existing report.json to merge seeds/families into "
                        "(means + orderings recomputed over the union)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    run_study(data_root=args.data_root, out_dir=args.out, seeds=args.seeds,
              max_epochs=args.max_epochs, quick=args.quick,
              device=args.device, families=tuple(args.families),
              box_version=args.box_version, merge_with=args.merge_with)
    return 0


if __name__ == "__main__":
    sys.exit(main())
