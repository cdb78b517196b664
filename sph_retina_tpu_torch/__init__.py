"""sph_retina_tpu_torch — the PyTorch/CUDA port of sph_retina_tpu.

Spherical object detection on an NVIDIA Hopper GPU: plain tensor code is
PyTorch, and the fused pairwise Sph2Pob IoU that the JAX package wrote as a
Pallas kernel for the TPU is a hand-written CUDA kernel (``csrc/``, built at
first use). So far the package holds the RetinaNet serving path:
``init_detector`` / ``inference_detector`` (``apis.py``) and the HTTP server
(``python -m sph_retina_tpu_torch.serve``).

Box conventions, degrees at the boundary, as in the JAX package:

- BFoV:  ``(theta, phi, alpha, beta)`` — longitude centre in [0, 360),
  colatitude centre in [0, 180), horizontal/vertical field of view in (0, 180).
- RBFoV: ``(theta, phi, alpha, beta, gamma)`` — adds a rotation in degrees.

The package imports ``torch`` and ``numpy`` only — nothing of JAX and nothing
of ``sph_retina_tpu``.
"""

__version__ = "0.1.0"
