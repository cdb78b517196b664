"""The port's assignment audit (``sph_retina_tpu_torch/assign_audit.py``)
against the JAX package's (``tools/assign_audit.py``).

Both run the whole audit on a 6-image sphere-bench val split at 128x256
(6 138 anchors), batch 3, backends ``sph2pob_efficient``,
``sph2pob_efficient_jnp`` and ``sph`` on the CPU, the JAX side as its own
test runs it:

- with the JAX side's ``pairwise`` asking the port for the overlaps (a
  ``pure_callback``), so that both count the same floats: every integer
  field equal, every float field within 1e-4 (the fields are rounded to 4
  digits; 1e-12 more for the binary fractions);
- on each package's own overlaps: equal counts of images, GTs and anchors,
  of >= 0.5 overlaps a GT, of band pairs and of threshold crossings; for
  ``sph`` (plain IoUs on both sides) equal positives too. Where the
  assignment takes a GT's best anchors (``overlaps == gt_max``, an exact
  float comparison) the packages part: their oracles differ by ~1e-6, and
  the val image 3's GT 6 claims anchor 1167 in JAX (0.076689422, its
  maximum) and not in the port (0.0766901448; its maximum 0.076690204 lies
  elsewhere) (ROADMAP C22); the port's ``sph2pob_efficient`` is the fused
  kernel's plain version where the JAX package on the CPU runs the unfused
  composite (C7). So there: positives a GT within 10 %, flip rates within
  2e-3.

``summarize`` of both on one seeded accumulator: equal.
"""

import importlib.util
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_retina_tpu_torch import assign_audit as port
from sph_retina_tpu_torch import synth_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs",
                      "sph_retinanet_r18_fpn_24e_spherebench.py")
BACKENDS = ("sph2pob_efficient", "sph2pob_efficient_jnp", "sph")
FLOAT_TOL = 1e-4 + 1e-12


def _jax_tool():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    spec = importlib.util.spec_from_file_location(
        "jax_assign_audit", os.path.join(REPO, "tools", "assign_audit.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jax_tool = _jax_tool()


@pytest.fixture(scope="module")
def audits(tmp_path_factory):
    root = tmp_path_factory.mktemp("audit")
    try:
        synth_dataset.write_sphere_bench(
            str(root / "data"), split="val", n_images=6, num_classes=4,
            img_size=(128, 256), box_version=4, seed=0)
        kw = dict(data_root=str(root / "data"), config=CONFIG, split="val",
                  backends=BACKENDS, batch=3,
                  extra_overrides=["img_size=(128,256)"])
        got = port.run_audit(out_dir=str(root / "port"), device="cpu", **kw)
        want = jax_tool.run_audit(out_dir=str(root / "jax"), **kw)
        cfg = port.apply_overrides(port.load_config(CONFIG), [
            "model.num_classes=4", "img_size=(128,256)"])
        with torch.device("meta"):
            _, det_cfg = port.get_family(cfg).build(cfg)
        anchors = det_cfg.flat_anchors("cpu")

        def port_overlaps(gt, jax_anchors, backend):
            def host(g):
                return port.pairwise(torch.from_numpy(np.array(g)), anchors,
                                     backend).numpy()

            shape = jax.ShapeDtypeStruct(
                (gt.shape[0], gt.shape[1], jax_anchors.shape[0]),
                jnp.float32)
            return jax.pure_callback(host, shape, gt)

        real = jax_tool.pairwise
        jax_tool.pairwise = port_overlaps
        try:
            same = jax_tool.run_audit(out_dir=str(root / "jax_same"), **kw)
        finally:
            jax_tool.pairwise = real
        files = {name: sorted(os.listdir(root / name))
                 for name in ("port", "jax")}
        with open(root / "port" / "ASSIGN_AUDIT.md") as f:
            port_md = f.read()
        with open(root / "jax_same" / "ASSIGN_AUDIT.md") as f:
            same_md = f.read()
        yield dict(got=json.loads(json.dumps(got)),
                   want=json.loads(json.dumps(want)),
                   same=json.loads(json.dumps(same)), files=files,
                   port_md=port_md, same_md=same_md)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _equal_fields(got, want, path=""):
    """Every key in the same order; integers and strings equal, floats
    within ``FLOAT_TOL``."""
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _equal_fields(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _equal_fields(g, w, f"{path}[{i}]")
    elif isinstance(want, float) or isinstance(got, float):
        assert abs(got - want) <= FLOAT_TOL, (path, got, want)
    else:
        assert got == want, (path, got, want)


def test_the_same_overlaps_give_the_same_report(audits):
    _equal_fields(audits["got"], audits["same"])
    assert audits["port_md"] == audits["same_md"]
    assert audits["files"]["port"] == audits["files"]["jax"] \
        == ["ASSIGN_AUDIT.md", "audit.json"]


def test_own_overlaps_agree_within_the_stated_tolerance(audits):
    got, want = audits["got"], audits["want"]
    assert {k: v for k, v in got.items() if k != "backends"} \
        == {k: v for k, v in want.items() if k != "backends"}
    assert got["n_images"] == 6 and got["n_anchors"] == 6138
    assert list(got["backends"]) == list(BACKENDS)
    for name in BACKENDS:
        g, w = got["backends"][name], want["backends"][name]
        for key in ("n_images", "n_gts", "thr_pos_per_gt_mean",
                    "gt_frac_zero_thr_pos"):
            assert g[key] == w[key], (name, key)
        band = "band_calibration_oracle_0.3_0.7"
        assert g[band]["n_pairs"] == w[band]["n_pairs"]
        assert g[band]["crossings"] == w[band]["crossings"]
        flips = [s["flip_confusion_vs_unbiased"]["anchor_category_flip_rate"]
                 for s in (g, w)]
        assert abs(flips[0] - flips[1]) <= 2e-3, (name, flips)
        if name == "sph":
            assert g["pos_total"] == w["pos_total"]
            assert g["pos_oracle_iou_mean"] == w["pos_oracle_iou_mean"]
        else:
            assert abs(g["pos_per_gt_mean"] - w["pos_per_gt_mean"]) \
                <= 0.1 * w["pos_per_gt_mean"], name
        total = sum(map(sum, g["flip_confusion_vs_unbiased"][
            "backend_rows_oracle_cols_ignore_neg_pos"]))
        assert total == got["n_anchors"] * g["n_images"]


def test_summarize_equals_the_jax_tools():
    rng = np.random.default_rng(5)
    acc = {
        "pos_per_gt_sum": np.int64(951), "gt_cnt": np.int64(27),
        "pos_per_gt_hist": rng.integers(0, 9, 64),
        "thr_per_gt_sum": np.int64(877), "thr_zero_gts": np.int64(2),
        "pos_cnt": np.int64(951), "pos_oracle_sum": np.float64(512.25),
        "pos_oracle_hist": rng.integers(0, 90, 20),
        "pos_below": {0.3: np.int64(40), 0.4: np.int64(77),
                      0.5: np.int64(130)},
        "conf": rng.integers(0, 5000, (3, 3)),
        "same_gt": np.int64(600), "both_cnt": np.int64(640),
        "band_cnt": np.int64(20_000), "band_err_sum": np.float64(-231.5),
        "band_abs_sum": np.float64(402.75),
        "crossings": {"demote_0.4": np.int64(9), "demote_0.5": np.int64(4),
                      "promote_0.4": np.int64(3), "promote_0.5": np.int64(1)},
        "n_images": np.int64(6),
    }
    assert port.summarize(acc) == jax_tool.summarize(acc)
