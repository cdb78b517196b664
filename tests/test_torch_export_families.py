"""Export of the single-stage families of the PyTorch port, on the CPU.

For FCOS, SSD-VGG16 and a Kent config (the RetinaNet family with the
``naive`` NMS), each cut to 64x128, fp32 (R18 where the config has a
ResNet): the artifact of ``export_predict`` equals the live ``predict_fn``
bitwise on seeded float32 images at batch 2, and its graph holds one
suppression loop a image. The rotated RetinaNet config is
``test_torch_export.py``'s, Faster R-CNN ``test_torch_export_frcnn.py``'s.
"""

import os

import numpy as np
import pytest
import torch

from sph_retina_tpu_torch.apis import init_detector
from sph_retina_tpu_torch.export import export_predict, load_exported

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["img_size=(64,128)", "bf16=False"]
# config, whether it has a ResNet, the greedy suppression loops of a batch
CONFIGS = {
    "fcos": ("sph_fcos_r50_fpn_120e_indoor360", True, 2),
    "ssd": ("sph_ssd_vgg16_120e_indoor360", False, 2),
    "kent": ("sph_kent_retinanet_kld_120e_indoor360", True, 2),
}


def check_artifact_equals_the_live_predict(config, resnet, loops):
    """The artifact of ``config`` at batch 2 against its live predict,
    bitwise; ``loops`` greedy suppression loops in its graph."""
    det = init_detector(os.path.join(REPO, "configs", config + ".py"),
                        cfg_options=SMALL + (["model.backbone.depth=18"]
                                             if resnet else []),
                        device="cpu")
    head = getattr(det.model, "bbox_head", None)
    if hasattr(head, "conv_cls"):
        # FCOS's focal prior keeps every score below score_thr: seeded
        # logits instead, so that its NMS has candidates
        with torch.no_grad():
            head.conv_cls.bias.copy_(torch.from_numpy(
                np.random.default_rng(0).normal(
                    0.0, 1.0, head.conv_cls.bias.shape).astype(np.float32)))
    rng = np.random.default_rng(1)
    images = torch.from_numpy(rng.normal(0.0, 1.0, (2, 64, 128, 3))
                              .astype(np.float32))
    call = load_exported(export_predict(det, batch_size=2))
    got = call(images)
    live = det.predict(images)
    for field, g, w in zip(live._fields, got, live):
        assert torch.equal(g, w), f"{config} {field}"
    assert int(live.valid.sum()) > 0
    assert sum(n.target is torch.ops.higher_order.while_loop
               for n in call.program.graph.nodes) == loops


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_artifact_equals_the_live_predict(name):
    check_artifact_equals_the_live_predict(*CONFIGS[name])
