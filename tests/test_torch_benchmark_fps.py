"""``sph_retina_tpu_torch/benchmark_fps.py`` times the config's own detector
(ROADMAP C20, repaired in the port; the JAX tool still builds a RetinaNet
for every config).

- For each of the 19 configs, the model ``benchmark_fps.main`` builds is of
  the family's type: the class name of the JAX package's
  ``get_family(cfg).build(cfg)`` module (built on the meta device here: no
  weights, no forward).
- ``--with-nms --device cpu`` on a small FCOS config (R18, 64x128, fp32)
  runs FCOS's predict, and never RetinaNet's.
"""

import glob
import io
import json
import os
from contextlib import redirect_stdout

import pytest
import torch

from sph_retina_tpu.engine import zoo as jzoo
from sph_retina_tpu_torch import benchmark_fps
from sph_retina_tpu_torch.engine import zoo
from sph_retina_tpu_torch.utils.config import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.py")))


class _Built(Exception):
    """Raised by the recording build once the model exists."""


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_benchmark_fps_builds_the_configs_family(path, monkeypatch):
    built = {}

    def recording(cfg):
        family = zoo.get_family(cfg)

        class Recorded(family):
            @staticmethod
            def build(c):
                with torch.device("meta"):
                    built["model"], _ = family.build(c)
                raise _Built

        return Recorded

    monkeypatch.setattr(benchmark_fps, "get_family", recording)
    with pytest.raises(_Built):
        benchmark_fps.main([path, "--device", "cpu"])
    cfg = load_config(path)
    jmodel, _ = jzoo.get_family(cfg).build(cfg)
    assert type(built["model"]).__name__ == type(jmodel).__name__
    assert type(built["model"]).__name__ == zoo.get_family(cfg).name


def test_with_nms_runs_the_fcos_predict(monkeypatch):
    calls = {"fcos": 0, "retina": 0}
    real_fcos, real_retina = zoo.fcos_predict, zoo.retina_predict

    def fcos(*args, **kw):
        calls["fcos"] += 1
        return real_fcos(*args, **kw)

    def retina(*args, **kw):
        calls["retina"] += 1
        return real_retina(*args, **kw)

    monkeypatch.setattr(zoo, "fcos_predict", fcos)
    monkeypatch.setattr(zoo, "retina_predict", retina)
    out = io.StringIO()
    with redirect_stdout(out):
        rc = benchmark_fps.main([
            os.path.join(REPO, "configs", "sph_fcos_r50_fpn_120e_indoor360.py"),
            "--with-nms", "--device", "cpu", "--warmup", "1", "--max-iter",
            "2", "--cfg-options", "model.backbone.depth=18",
            "img_size=(64,128)", "bf16=False"])
    assert rc == 0
    rec = json.loads(out.getvalue().splitlines()[-1])
    assert rec["with_nms"] and rec["img_size"] == [64, 128]
    assert rec["device"] == "cpu" and rec["img_per_s"] > 0
    assert calls == {"fcos": 3, "retina": 0}
