from .resnet import ResNet
from .fpn import FPN
from .vgg import SSDVGG, SSDNeck
from .heads.retina_head import SphRetinaHead
from .single_stage import SphRetinaNet
from .fcos import SphFCOS, SphFCOSHead
from .ssd import SphSSD, SphSSDHead
from .faster_rcnn import SphFasterRCNN, SphRPNHead, Shared2FCBBoxHead

# The JAX package also exports its weight converters from here
# (port_torchvision_weights, port_torchvision_vgg16, load_backbone,
# load_torch_state_dict, port_mmdet_retinanet); they are not ported yet
# (ROADMAP).
__all__ = [
    "ResNet",
    "FPN", "SSDVGG", "SSDNeck",
    "SphRetinaHead", "SphRetinaNet", "SphFCOS", "SphFCOSHead",
    "SphSSD", "SphSSDHead", "SphFasterRCNN", "SphRPNHead",
    "Shared2FCBBoxHead",
]
