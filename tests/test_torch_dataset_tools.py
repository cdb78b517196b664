"""The port's dataset converters (``sph_retina_tpu_torch/{chart_util,
convert_anno, images2coco, get_image_metas, split_coco, pascal_voc,
cityscapes}.py``) against the JAX package's ``tools/`` twins.

Each pair runs on the same files, written here from seeded numpy arrays
(images, VOC XML, a Cityscapes instance-id map with a crowd id in two
separate regions, COCO files), and must write equal JSON; ``pix2bfov``
within 1e-12. The JAX tools that have only a ``main`` run in-process
through ``runpy`` with ``sys.argv`` set. Everything written lies under
``tmp_path`` and is removed once the test is done.
"""

import importlib.util
import json
import os
import runpy
import shutil
import sys

import numpy as np
import pytest
from PIL import Image

from sph_retina_tpu_torch import (
    chart_util,
    cityscapes,
    convert_anno,
    get_image_metas,
    images2coco,
    pascal_voc,
    split_coco,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")


def _load(name):
    sys.path.insert(0, TOOLS)
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax_main(name, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [name] + [str(a) for a in argv])
    runpy.run_path(os.path.join(TOOLS, f"{name}.py"), run_name="__main__")


def _json(path):
    with open(path) as f:
        return json.load(f)


@pytest.fixture
def emptied_tmp_path(tmp_path):
    """``tmp_path``, emptied once the test is done with it."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_pix2bfov_equals_the_jax_helper():
    jax_chart = _load("chart_util")
    rng = np.random.default_rng(0)
    for x1, y1, dx, dy, w, h in zip(*(rng.uniform(0, 900, 20)
                                      for _ in range(4)),
                                    rng.integers(400, 2000, 20),
                                    rng.integers(200, 1000, 20)):
        args = (x1, y1, x1 + dx, y1 + dy, int(w), int(h))
        np.testing.assert_allclose(chart_util.pix2bfov(*args),
                                   jax_chart.pix2bfov(*args),
                                   rtol=0, atol=1e-12)


def _coco(seed: int, n_images=10) -> dict:
    rng = np.random.default_rng(seed)
    images = [{"id": i + 1, "file_name": f"{i:03d}.jpg", "width": 512,
               "height": 256} for i in range(n_images)]
    anns = [{"id": j + 1, "image_id": int(rng.integers(1, n_images + 1)),
             "category_id": int(rng.integers(1, 4)),
             "bbox": [float(rng.uniform(-3.1, 3.1)),
                      float(rng.uniform(-1.5, 1.5)),
                      float(rng.uniform(5, 60)), float(rng.uniform(5, 60))],
             "iscrowd": 0, "area": 1.0} for j in range(25)]
    return {"images": images, "annotations": anns,
            "categories": [{"id": c, "name": f"c{c}"} for c in (1, 2, 3)]}


def test_convert_anno_equals_the_jax_tools(emptied_tmp_path, monkeypatch):
    src = emptied_tmp_path / "raw.json"
    src.write_text(json.dumps(_coco(1)))
    convert_anno.main([str(src), "--out", str(emptied_tmp_path / "p.json")])
    _run_jax_main("convert_anno",
                  [src, "--out", emptied_tmp_path / "j.json"], monkeypatch)
    got = _json(emptied_tmp_path / "p.json")
    assert got == _json(emptied_tmp_path / "j.json")
    assert got != _json(src)


def test_split_coco_equals_the_jax_tools(emptied_tmp_path):
    jax_split = _load("split_coco")
    src = emptied_tmp_path / "ann.json"
    src.write_text(json.dumps(_coco(2)))
    got = split_coco.split(str(src), str(emptied_tmp_path / "p"),
                           [20, 50], 2, seed=3)
    want = jax_split.split(str(src), str(emptied_tmp_path / "j"),
                           [20, 50], 2, seed=3)
    assert [os.path.basename(p) for p in got] \
        == [os.path.basename(p) for p in want]
    assert len(got) == 8
    for g, w in zip(got, want):
        assert _json(g) == _json(w)
    lab = _json(got[0])
    assert len(lab["images"]) == 2 and lab["annotations"]


def _write_images(root, seed: int) -> list:
    rng = np.random.default_rng(seed)
    os.makedirs(root)
    names = []
    for i, (h, w) in enumerate([(32, 64), (40, 80), (24, 48)]):
        name = f"img{i}." + ("png" if i != 1 else "jpg")
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)) \
            .save(os.path.join(root, name))
        names.append(name)
    with open(os.path.join(root, "notes.txt"), "w") as f:
        f.write("not an image\n")
    return names


def test_images2coco_and_get_image_metas_equal_the_jax_tools(
        emptied_tmp_path, monkeypatch):
    img_dir = str(emptied_tmp_path / "imgs")
    _write_images(img_dir, seed=3)
    classes = emptied_tmp_path / "classes.txt"
    classes.write_text("person\n\ncar\n")
    for name, run in (("p", lambda argv: images2coco.main(argv)),
                      ("j", lambda argv: _run_jax_main(
                          "images2coco", argv, monkeypatch))):
        run([img_dir, str(classes), str(emptied_tmp_path / f"{name}.json"),
             "--exclude-extensions", "jpg"])
    got = _json(emptied_tmp_path / "p.json")
    assert got == _json(emptied_tmp_path / "j.json")
    assert [im["file_name"] for im in got["images"]] == ["img0.png",
                                                         "img2.png"]

    for name, run in (("p", lambda argv: get_image_metas.main(argv)),
                      ("j", lambda argv: _run_jax_main(
                          "get_image_metas", argv, monkeypatch))):
        run(["--img-dir", img_dir, "--out",
             str(emptied_tmp_path / f"metas_{name}.json"), "--workers", "2"])
        run(["--ann-file", str(emptied_tmp_path / "p.json"), "--img-prefix",
             img_dir, "--out", str(emptied_tmp_path / f"ann_{name}.json")])
    for kind in ("metas", "ann"):
        got = _json(emptied_tmp_path / f"{kind}_p.json")
        assert got == _json(emptied_tmp_path / f"{kind}_j.json")
    assert [(m["width"], m["height"]) for m in got] == [(64, 32), (48, 24)]


VOC_XML = """<annotation><filename>{f}</filename>
<size><width>{w}</width><height>{h}</height></size>
{objects}</annotation>"""
VOC_OBJECT = """<object><name>{name}</name><difficult>{d}</difficult>
<bndbox><xmin>{x1}</xmin><ymin>{y1}</ymin><xmax>{x2}</xmax><ymax>{y2}</ymax>
</bndbox></object>"""


def test_pascal_voc_equals_the_jax_tools(emptied_tmp_path):
    jax_voc = _load("pascal_voc")
    rng = np.random.default_rng(4)
    xml_dir = emptied_tmp_path / "Annotations"
    xml_dir.mkdir()
    for i in range(4):
        w, h = int(rng.integers(300, 800)), int(rng.integers(200, 400))
        objects = "".join(VOC_OBJECT.format(
            name=rng.choice(list(pascal_voc.VOC_CLASSES) + ["unknown"]),
            d=int(rng.random() < 0.3), x1=int(x1), y1=int(y1),
            x2=int(x1 + rng.integers(5, 100)),
            y2=int(y1 + rng.integers(5, 100)))
            for x1, y1 in zip(rng.integers(1, 200, 3),
                              rng.integers(1, 100, 3)))
        (xml_dir / f"{i:06d}.xml").write_text(VOC_XML.format(
            f=f"{i:06d}.jpg", w=w, h=h, objects=objects))
    ids = ["000000", "000002", "000003"]
    got = pascal_voc.convert(str(xml_dir), str(emptied_tmp_path / "p.json"),
                             "JPEGImages", ids)
    want = jax_voc.convert(str(xml_dir), str(emptied_tmp_path / "j.json"),
                           "JPEGImages", ids)
    assert got == want == _json(emptied_tmp_path / "p.json") \
        == _json(emptied_tmp_path / "j.json")
    assert len(got["images"]) == 3 and got["annotations"]
    assert any(a["iscrowd"] for a in got["annotations"])


def test_cityscapes_equals_the_jax_tools(emptied_tmp_path):
    """One map with two instances, a label without instances, and a crowd
    id (24, person) in two separate regions: two crowd records."""
    jax_city = _load("cityscapes")
    inst = np.full((40, 96), 7, np.int32)           # road: no instances
    inst[2:10, 3:12] = 24                           # crowd, first region
    inst[30:38, 80:94] = 24                         # crowd, second region
    inst[12:25, 20:40] = 26001                      # car 1
    inst[5:15, 50:70] = 24002                       # person 2
    gt_dir = emptied_tmp_path / "gtFine" / "train" / "aachen"
    gt_dir.mkdir(parents=True)
    Image.fromarray(inst).save(
        gt_dir / "aachen_000000_000019_gtFine_instanceIds.png")
    records = cityscapes.instances_from_idmap(inst)
    assert records == jax_city.instances_from_idmap(inst)
    assert sorted(r[1] for r in records) == [0, 0, 1, 1]
    root = str(emptied_tmp_path / "gtFine" / "train")
    got = cityscapes.convert(root, str(emptied_tmp_path / "p.json"))
    want = jax_city.convert(root, str(emptied_tmp_path / "j.json"))
    assert got == want == _json(emptied_tmp_path / "p.json") \
        == _json(emptied_tmp_path / "j.json")
    assert got["images"][0]["file_name"] \
        == "aachen/aachen_000000_000019_leftImg8bit.png"
    assert len(got["annotations"]) == 4
