from .resnet import ResNet, port_torchvision_weights
from .fpn import FPN
from .vgg import SSDVGG, SSDNeck, port_torchvision_vgg16
from .port import load_backbone, load_torch_state_dict
from .port_mmdet import port_mmdet_retinanet
from .heads.retina_head import SphRetinaHead
from .single_stage import SphRetinaNet
from .fcos import SphFCOS, SphFCOSHead
from .ssd import SphSSD, SphSSDHead
from .faster_rcnn import SphFasterRCNN, SphRPNHead, Shared2FCBBoxHead

__all__ = [
    "ResNet", "port_torchvision_weights", "port_torchvision_vgg16",
    "load_backbone", "load_torch_state_dict", "port_mmdet_retinanet",
    "FPN", "SSDVGG", "SSDNeck",
    "SphRetinaHead", "SphRetinaNet", "SphFCOS", "SphFCOSHead",
    "SphSSD", "SphSSDHead", "SphFasterRCNN", "SphRPNHead",
    "Shared2FCBBoxHead",
]
