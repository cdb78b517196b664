"""Export of the Faster R-CNN family of the PyTorch port, on the CPU.

The indoor360 leaves with hard NMS and with soft-NMS, cut to R18, 64x128,
fp32: the artifact equals the live ``predict_fn`` bitwise at batch 2 (the
RPN's planar NMS at k = 2 048 a image, RoIAlign, the RoI head, the final
NMS or soft-NMS), as ``test_torch_export_families.py`` checks it.
"""

import pytest

from test_torch_export_families import check_artifact_equals_the_live_predict

# config, whether it has a ResNet, the greedy suppression loops of a batch:
# the RPN's a image, and the final NMS's unless it is soft-NMS (a bounded
# argmax loop, unrolled)
CONFIGS = {
    "hard_nms": ("sph_faster_rcnn_r50_fpn_120e_indoor360", True, 4),
    "soft_nms": ("sph_faster_rcnn_r50_fpn_soft_nms_120e_indoor360", True, 2),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_artifact_equals_the_live_predict(name):
    check_artifact_equals_the_live_predict(*CONFIGS[name])
