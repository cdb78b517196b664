"""sph_retina_tpu_torch — the PyTorch/CUDA port of sph_retina_tpu.

Spherical object detection on an NVIDIA Hopper GPU: plain tensor code is
PyTorch, and the two fused Sph2Pob IoU kernels that the JAX package wrote in
Pallas for the TPU (pairwise and aligned) are hand-written CUDA kernels
(``csrc/``, built at first use). So far the package holds, for every
detector family (RetinaNet, FCOS, SSD-VGG16, Faster R-CNN):

- the serving path: ``init_detector`` / ``inference_detector`` (``apis.py``)
  and the HTTP server (``python -m sph_retina_tpu_torch.serve``), with
  greedy NMS or soft-NMS;
- the training path: ``python -m sph_retina_tpu_torch.train CONFIG`` (anchor
  assignment through the pairwise kernel, or point targets for FCOS; focal or
  cross-entropy with hard-negative mining; the RPN, RoIAlign and the RoI
  sampler, random or OHEM; the L1, IoU-family, Gaussian and Kent regression
  losses; SGD with warm-up, clip, frozen stages and EMA, the synthetic
  dataset);
- the spherical IoU backends (``iou.api.sph_overlaps``: the three Sph2Pob
  transforms, the unbiased oracle, Sph-IoU, FoV-IoU, the chart IoU, the Kent
  KLD surrogate), in plain differentiable PyTorch;
- the IoU tool: ``python -m sph_retina_tpu_torch.benchmark_iou`` (the aligned
  kernel against its plain version, the backends against the oracle);
- export: ``export_predict`` / ``load_exported`` (``export.py``, one
  ``torch.export`` artifact of the whole predict path), the CLIs
  ``python -m sph_retina_tpu_torch.export_model`` and
  ``python -m sph_retina_tpu_torch.deployment_test`` (an artifact scored
  over a dataset).

Box conventions, degrees at the boundary, as in the JAX package:

- BFoV:  ``(theta, phi, alpha, beta)`` — longitude centre in [0, 360),
  colatitude centre in [0, 180), horizontal/vertical field of view in (0, 180).
- RBFoV: ``(theta, phi, alpha, beta, gamma)`` — adds a rotation in degrees.

The package imports ``torch`` and ``numpy`` only — nothing of JAX and nothing
of ``sph_retina_tpu``.
"""

__version__ = "0.1.0"
__all__ = ["export_predict", "load_exported"]


def __getattr__(name):
    # PEP 562: importing the package stays light; the names load on use
    if name in __all__:
        from . import export

        return getattr(export, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
