"""The measurement tools of the PyTorch port, on the CPU, against the JAX
package's tools (``tools/<name>.py`` loaded by path and run in this
process; no process is started):

- ``print_config``: the text equals the JAX tool's byte for byte, for
  every config in ``configs/``;
- ``get_flops``: the parameters equal the JAX tool's; the forward FLOPs are
  within 1 % of XLA's cost analysis (the JAX tool's count) at the R18
  Sphere-bench config at 64x128 and the rotated R50 config at 128x256 (the
  rest is XLA counting bf16 conversions on the CPU: within 0.07 % at
  fp32); a convolution's count equals XLA's exactly; a train step's
  products equal an independent loop over the model's convolutions;
- ``benchmark_fps``: the JAX tool's JSON keys, with and without
  ``--with-nms``; it raises without a card unless told ``--device cpu``;
- ``profile_step``: a trace file written, the breakdown's rows those the
  JAX tool prints, ``--memory`` unavailable on the CPU;
- ``mfu_experiment``: an empty experiment list writes ``{}``; a child in
  this process gives ``step_ms`` and no ``mfu`` on the CPU, and saves its
  assignment's IoU input;
- ``bench_host_pipeline``: the report's keys equal the JAX tool's.

Every trace, report and JPEG cache is written under ``tmp_path`` and
removed at the end (C12).
"""

import contextlib
import glob
import importlib.util
import io
import json
import os
import re
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_retina_tpu_torch import bench_host_pipeline as host_cli
from sph_retina_tpu_torch import benchmark_fps as fps_cli
from sph_retina_tpu_torch import get_flops as flops_cli
from sph_retina_tpu_torch import mfu_experiment as mfu_cli
from sph_retina_tpu_torch import print_config as config_cli
from sph_retina_tpu_torch import profile_step as profile_cli
from sph_retina_tpu_torch.engine.builder import build_tx
from sph_retina_tpu_torch.engine.zoo import (
    get_family,
    make_generic_train_step,
)
from sph_retina_tpu_torch.utils.config import apply_overrides, load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
TINY = """\
model = dict(type='SphRetinaNet', num_classes=3, box_version=5,
             backbone=dict(depth=18))
img_size = (64, 128)
bf16 = False
test_cfg = dict(iou_calculator='sph2pob_efficient')
"""
FLOP_TOLERANCE = 0.01  # relative, against XLA's count


@pytest.fixture
def emptied_tmp_path(tmp_path):
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture
def tiny_cfg(emptied_tmp_path):
    path = emptied_tmp_path / "tiny.py"
    path.write_text(TINY)
    return str(path)


def _said(fn) -> str:
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert fn() in (0, None)
    return out.getvalue()


def _jax_tool(name: str, argv):
    """``tools/<name>.py``'s ``main()`` with ``sys.argv`` set; its stdout."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    saved = sys.argv
    sys.argv = [f"{name}.py", *argv]
    try:
        return _said(module.main)
    finally:
        sys.argv = saved


def _line(text: str, key: str) -> str:
    return next(x for x in text.splitlines() if x.startswith(key))


@pytest.mark.parametrize("path", sorted(
    glob.glob(os.path.join(REPO, "configs", "*.py"))), ids=os.path.basename)
def test_print_config_is_the_jax_tools_text(path):
    argv = [path, "--cfg-options", "optimizer.lr=0.02"]
    assert _said(lambda: config_cli.main(argv)) \
        == _jax_tool("print_config", argv)


# --------------------------------------------------------------------------- #
# get_flops
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("config,shape", [
    ("sph_retinanet_r18_fpn_24e_spherebench.py", (64, 128)),
    ("sph_rotated_retinanet_r50_fpn_120e_pandora.py", (128, 256)),
])
def test_get_flops_against_the_jax_tool(config, shape):
    argv = [os.path.join(REPO, "configs", config), "--shape",
            *map(str, shape), "--device", "cpu"]
    got = _said(lambda: flops_cli.main(argv))
    want = _jax_tool("get_flops", argv)
    for key in ("config:", "input:", "params:"):
        assert _line(got, key) == _line(want, key)

    def giga(text):
        return float(re.search(r"flops:\s+([\d.]+) GFLOPs",
                               _line(text, "flops:")).group(1))

    # the port's exact count, against the JAX tool's to its 2 decimals
    cfg = apply_overrides(load_config(argv[0]), None)
    cfg["img_size"] = shape
    model, _ = get_family(cfg).build(cfg)
    with torch.no_grad():
        count = flops_cli.count_flops(model.eval(),
                                      torch.zeros((1, *shape, 3)))
    assert abs(count.total / 1e9 - giga(got)) <= 0.005
    assert abs(count.total / (giga(want) * 1e9) - 1.0) < FLOP_TOLERANCE
    assert count.flops["elementwise"] < 0.01 * count.flops["convolution"]
    assert count.bytes > 0


@pytest.mark.parametrize("config", [
    "sph_retinanet_r18_fpn_24e_spherebench.py",
    "sph_fcos_r50_fpn_120e_indoor360.py"])
def test_get_flops_counts_the_head_apart(config):
    """The head's line is ``count_flops`` of the head on the forward's
    neck outputs."""
    argv = [os.path.join(REPO, "configs", config), "--shape", "64", "128",
            "--device", "cpu", "--cfg-options", "model.backbone.depth=18"]
    said = _said(lambda: flops_cli.main(argv))
    cfg = apply_overrides(load_config(argv[0]), argv[-1:])
    cfg["img_size"] = (64, 128)
    model, _ = get_family(cfg).build(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        x = torch.zeros((1, 64, 128, 3)).to(model.dtype).permute(0, 3, 1, 2)
        head = flops_cli.count_flops(model.bbox_head,
                                     model.neck(model.backbone(x))).total
        total = flops_cli.count_flops(model.eval(),
                                      torch.zeros((1, 64, 128, 3))).total
    assert 0 < head < total
    assert _line(said, "head:") == (
        f"head:       {head / 1e9:.2f} GFLOPs "
        f"({100 * head / total:.1f} % of the forward)")


@pytest.mark.parametrize("x,w,stride,padding,dilation,groups", [
    ((1, 3, 64, 128), (64, 3, 7, 7), 2, 3, 1, 1),       # the stem
    ((2, 64, 17, 33), (64, 64, 3, 3), 1, 1, 1, 1),     # ragged edges
    ((1, 128, 16, 32), (128, 4, 3, 3), 2, 1, 1, 32),   # ResNeXt's grouped
    ((1, 512, 8, 16), (1024, 512, 3, 3), 1, 6, 6, 1),  # SSD's dilated conv6
    ((1, 256, 15, 31), (512, 256, 1, 1), 2, 0, 1, 1),  # a downsample
])
def test_a_convolutions_count_is_xlas(x, w, stride, padding, dilation,
                                      groups):
    """XLA counts 2 FLOPs a multiply-add over the taps inside the input."""
    lhs = jnp.zeros(x, jnp.float32)
    rhs = jnp.zeros(w, jnp.float32)

    def conv(a, b):
        return jax.lax.conv_general_dilated(
            a, b, (stride, stride), [(padding, padding)] * 2,
            rhs_dilation=(dilation, dilation), feature_group_count=groups)

    cost = jax.jit(conv).lower(lhs, rhs).compile().cost_analysis()
    cost = cost[0] if isinstance(cost, list) else cost
    count = flops_cli.count_flops(
        torch.nn.functional.conv2d, torch.zeros(x), torch.zeros(w), None,
        stride, padding, dilation, groups)
    assert count.flops["convolution"] == cost["flops"]
    assert count.products == count.total


def _independent_macs(x_shape, conv) -> int:
    """Multiply-adds of ``conv`` on an input of ``x_shape`` over the taps
    inside the input, by numpy over every (output, tap) pair."""
    n, c_in = x_shape[:2]
    taps = 1
    for size, k, s, p, d in zip(x_shape[2:], conv.kernel_size, conv.stride,
                                conv.padding, conv.dilation):
        out = (size + 2 * p - d * (k - 1) - 1) // s + 1
        idx = np.arange(out)[:, None] * s - p + np.arange(k)[None] * d
        taps *= int(((idx >= 0) & (idx < size)).sum())
    return n * conv.out_channels * (c_in // conv.groups) * taps


@pytest.mark.parametrize("model", [
    dict(type="SphRetinaNet", backbone=dict(depth=18)),
    dict(type="SphSSD"),
])
def test_a_train_steps_products_equal_a_loop_over_the_convolutions(model):
    """Forward, plus the input gradient where the input requires grad and
    the weight gradient where the weight does (the frozen stem and stage 1
    need neither)."""
    cfg = {"model": dict(model, num_classes=3, box_version=4),
           "img_size": (64, 128), "bf16": False}
    family = get_family(cfg)
    net, det_cfg = family.build(cfg)
    net.init_weights(torch.Generator().manual_seed(0))
    step = make_generic_train_step(family, net, det_cfg,
                                   build_tx(cfg, net, 1))
    batch = profile_cli.make_batch(cfg, 2, CPU)
    want = []

    def hook(conv, inputs, _):
        x = inputs[0]
        passes = 1 + int(x.requires_grad) + int(conv.weight.requires_grad)
        want.append(2 * _independent_macs(tuple(x.shape), conv) * passes)

    handles = [m.register_forward_hook(hook) for m in net.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    assert not any(isinstance(m, torch.nn.Linear) for m in net.modules())
    count = flops_cli.count_flops(step, batch)
    for h in handles:
        h.remove()
    assert count.products == sum(want) > 0
    assert count.flops["matmul"] == 0


# --------------------------------------------------------------------------- #
# benchmark_fps, profile_step
# --------------------------------------------------------------------------- #
def test_benchmark_fps_keys_are_the_jax_tools(tiny_cfg):
    argv = [tiny_cfg, "--max-iter", "2", "--warmup", "1", "--device", "cpu"]
    # one dict literal in the JAX tool, whichever branch runs
    want = json.loads(_jax_tool("benchmark_fps", argv).splitlines()[-1])
    for extra in ([], ["--with-nms"]):
        got = json.loads(
            _said(lambda: fps_cli.main(argv + extra)).splitlines()[-1])
        assert list(got) == list(want)
        assert got["with_nms"] is bool(extra)
        assert got["img_size"] == want["img_size"] == [64, 128]
        assert got["batch_size"] == 1 and got["img_per_s"] > 0
        assert got["device"] == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fps_cli.main(argv[:-2])


def test_profile_step_on_the_cpu(tiny_cfg, emptied_tmp_path):
    logdir = emptied_tmp_path / "trace"
    said = _said(lambda: profile_cli.main(
        [tiny_cfg, "--device", "cpu", "--batch-size", "1", "--steps", "1",
         "--logdir", str(logdir)]))
    path = logdir / "train_step.json"
    assert said.strip() == f"trace written to {path}"
    assert json.loads(path.read_text())["traceEvents"]

    said = _said(lambda: profile_cli.main(
        [tiny_cfg, "--device", "cpu", "--batch-size", "1", "--memory"]))
    assert said.strip() == "memory_analysis unavailable on this backend"

    cfg = load_config(tiny_cfg)
    batch = profile_cli.make_batch(cfg, 1, CPU)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rows = profile_cli.report_breakdown(cfg, batch, CPU, n=1)
    with open(os.path.join(REPO, "tools", "profile_step.py")) as f:
        jax_source = f.read()
    names = [name.replace("R18", "R%d") for name, _ in rows]
    assert len(names) == 6
    for name in names:
        assert repr(name).strip("'") in jax_source, name
    lines = out.getvalue().splitlines()
    assert lines[0] == "train-step breakdown  batch=1  64x128  platform=cpu"
    assert [x[2:46].rstrip() for x in lines[1:]] \
        == [name for name, _ in rows]
    assert all(ms >= 0.0 for _, ms in rows) and rows[-1][1] > 0.0


# --------------------------------------------------------------------------- #
# mfu_experiment, bench_host_pipeline
# --------------------------------------------------------------------------- #
def test_mfu_experiment(emptied_tmp_path):
    out_json = emptied_tmp_path / "mfu.json"
    said = _said(lambda: mfu_cli.main(["--out", str(out_json),
                                       "--experiments"]))
    assert json.loads(out_json.read_text()) == {}
    assert json.loads(said) == {}
    assert mfu_cli.EXPERIMENTS == {"baseline": None}

    saved = emptied_tmp_path / "iou_input.pt"
    with contextlib.redirect_stdout(io.StringIO()) as out:
        res = mfu_cli.child(batch=1, h=64, w=128, device="cpu",
                            save_iou_input=str(saved))
    assert out.getvalue() == "CHILD_RESULT " + json.dumps(res) + "\n"
    assert res["step_ms"] > 0 and res["imgs_per_sec"] > 0
    assert res["flops_per_step"] > 0 and "mfu" not in res
    boxes1, boxes2 = torch.load(saved)
    assert tuple(boxes1.shape) == (16, 4) and tuple(boxes2.shape) == (1539, 4)


def test_bench_host_pipeline_keys_are_the_jax_tools(emptied_tmp_path,
                                                    monkeypatch):
    monkeypatch.setenv("TMPDIR", str(emptied_tmp_path))
    argv = ["--img-size", "64", "128", "--n-images", "8", "--workers", "1",
            "2"]
    got_path, want_path = (emptied_tmp_path / "port.json",
                           emptied_tmp_path / "jax.json")
    said = _said(lambda: host_cli.main(argv + ["--out", str(got_path)]))
    _jax_tool("bench_host_pipeline", argv + ["--out", str(want_path)])
    got = json.loads(got_path.read_text())
    want = json.loads(want_path.read_text())
    assert list(got) == list(want)
    assert list(got["stages_single_thread"]) \
        == list(want["stages_single_thread"])
    assert got["loader_imgs_per_sec"].keys() \
        == want["loader_imgs_per_sec"].keys() == {"rgb", "yuv420"}
    for cs in ("rgb", "yuv420"):
        assert list(got["loader_imgs_per_sec"][cs]) == ["1", "2"]
        assert all(v > 0 for v in got["loader_imgs_per_sec"][cs].values())
    assert got["stages_single_thread"]["pil_decode_ms"] > 0
    assert "| workers | rgb img/s | yuv420 img/s |" in said
    assert os.path.isdir(emptied_tmp_path / "sph_retina_bench_jpegs_64x128_8")
