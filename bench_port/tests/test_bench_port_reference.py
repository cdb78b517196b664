"""The plain reference against the port on the CPU at a tiny size, both in
float32: a train step of each configuration, and ``inference_detector``."""

from __future__ import annotations

import pytest
import torch

from bench_port import calibrate, judge, run
from bench_port.kinds import detect, train


def _run(cell, seed=3):
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    w = run.find_cell(bench, cell)
    config = run.load_json(run.HERE, "configs", f"{w['config']}.json")
    mix = run.load_json(run.HERE, "traffic", f"{w['traffic']}.json")
    args = type("Args", (), {"seed": seed, "seconds": 0.0, "trace": 0})
    return run.make_run(config, mix, args, torch.device("cpu"))


def test_train_steps_agree(tiny):
    for cell in ("rretina_r50_pandora.train_b64",
                 "fcos_r50_indoor360.train_b16"):
        numbers = calibrate.train_seed(_run(cell))["program"]
        assert numbers["loss_gap"] < 1e-5, (cell, numbers)
        assert numbers["grad_gap"] < 1e-3, (cell, numbers)
        assert numbers["update_gap"] < 1e-3, (cell, numbers)


def test_inference_detector_agrees(tiny):
    r = _run("rretina_r50_pandora.detect_b16")
    readings = calibrate.detect_seed(r)
    assert readings["program"]["missed"] == 0.0, readings
    assert readings["program"]["score_gap"] < 1e-4, readings
    assert readings["kept_per_image"] == r.config["test"]["max_per_img"]


def test_reference_results_round_trip(tiny):
    """The reference's detections, put in the program's place, are judged
    equal to themselves."""
    r = _run("rretina_r50_pandora.detect_b16")
    from bench_port import traffic
    from bench_port.weights import make_weights

    weights = {k: v.cpu() for k, v in make_weights(r.config, 1,
                                                   r.device).items()}
    frames = traffic.detect_pool(r.config, r.mix, 1)[:1]
    refs = detect.reference_detections(r, weights, frames)
    got = judge.detect_numbers(detect.as_results(refs, r.config["num_classes"]),
                               refs, r.config["test"]["max_per_img"], r.device)
    assert got == {"missed": 0.0, "score_gap": 0.0}


def test_train_numbers_of_identical_runs_are_zero():
    g = {"a": torch.ones(3), "b": torch.full((2,), 2.0)}
    same = {"losses": [{"loss": 1.0, "loss_cls": 0.5}], "grad": g,
            "delta": g, "p0": g}
    assert set(judge.train_numbers(same, same).values()) == {0.0}
    assert train._cpu(g)["a"].dtype == torch.float32


def test_loss_gaps_of_the_total_and_each_term():
    """``loss_gap`` compares the total loss a step minimises, terms that
    move apart and cancel leave it at 0; ``loss_gap.<term>`` each term."""
    g = {"a": torch.ones(3)}
    ref = {"losses": [{"loss": 2.0, "loss_cls": 1.0, "loss_bbox": 1.0},
                      {"loss": 4.0, "loss_cls": 2.0, "loss_bbox": 2.0}],
           "grad": g, "delta": g, "p0": g}
    prog = {"losses": [{"loss": 2.0, "loss_cls": 1.5, "loss_bbox": 0.5},
                       {"loss": 4.2, "loss_cls": 2.0, "loss_bbox": 2.2}],
            "grad": g, "delta": g}
    got = judge.train_numbers(prog, ref)
    assert got["loss_gap"] == pytest.approx(0.05)
    assert got["loss_gap.loss_cls"] == pytest.approx(0.5)
    assert got["loss_gap.loss_bbox"] == pytest.approx(0.5)
