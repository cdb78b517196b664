"""Serving-path export: a detector's predict path -> one ``torch.export``
artifact.

The twin of the JAX package's ``export.py`` (StableHLO through
``jax.export``). The whole predict path — backbone, FPN, head, decode, NMS —
is one module with static shapes (``engine.zoo.PredictModule``), so
``torch.export`` captures it as one graph: the pairwise Sph2Pob IoU of the
NMS stays one ``sph_retina.sph2pob_iou_pairwise`` node (a custom op, which
launches the CUDA kernel when the program runs on the card), and the greedy
suppression one ``while_loop`` node. ``export_predict`` writes the program
with the weights and the anchors in it (``export_program`` traces,
``save_program`` serializes); ``load_exported`` reads it back and returns a
callable that needs none of the model's Python code.

An artifact runs on the device it was exported on. ``torch.export`` has no
artifact for several platforms, so a ``platforms`` entry other than that
device raises; loading an artifact exported on the card raises where there
is none, and never moves it to the CPU.
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import Sequence

import torch
from torch.export.graph_signature import InputKind

__all__ = ["artifact_meta", "export_predict", "export_program",
           "load_exported", "save_program"]

_META = "sph_retina_meta.json"


def export_program(det, batch_size: int = 1,
                   platforms: Sequence[str] | None = None):
    """The detector's full predict path as a ``torch.export``
    ``ExportedProgram``, traced on ``det.device`` (what
    :func:`export_predict` serializes)."""
    from .engine.zoo import get_family

    device = torch.device(det.device)
    for p in platforms or ():
        if p != device.type:
            raise NotImplementedError(
                f"platform {p!r}: a torch.export artifact runs only on the "
                f"device it was exported on, here {device.type!r}; export on "
                "each platform separately")
    h, w = det.cfg.get("img_size", (512, 1024))
    module = get_family(det.cfg).predict_module(det.model, det.det_cfg)
    example = torch.zeros((batch_size, h, w, 3), dtype=torch.float32,
                          device=device)
    with torch.no_grad():
        return torch.export.export(module, (example,), strict=False)


def save_program(program) -> bytes:
    """``torch.export.save`` of an :func:`export_program` into bytes, with
    the program's device and input spec beside it (:func:`artifact_meta`)."""
    (spec,) = [s for s in program.graph_signature.input_specs
               if s.kind == InputKind.USER_INPUT]
    image = next(n for n in program.graph.nodes
                 if n.name == spec.arg.name).meta["val"]
    meta = {"device": image.device.type, "input_shape": list(image.shape),
            "input_dtype": str(image.dtype).removeprefix("torch.")}
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files={_META: json.dumps(meta)})
    return buf.getvalue()


def export_predict(det, batch_size: int = 1,
                   platforms: Sequence[str] | None = None) -> bytes:
    """Serialize the detector's full predict path into artifact bytes.

    ``det`` is what ``apis.init_detector`` returns. The input is float32
    NHWC ``(batch_size, H, W, 3)`` at the config's ``img_size``, normalised,
    as the JAX package's export takes it. ``platforms`` may only name the
    detector's own device (``"cpu"`` or ``"cuda"``); anything else raises
    ``NotImplementedError``. Returns the bytes of
    ``torch.export.save`` (write them to a file; ``load_exported`` reads
    them back).
    """
    return save_program(export_program(det, batch_size, platforms))


def artifact_meta(data: bytes) -> dict:
    """The artifact's device and input spec (``device``, ``input_shape``,
    ``input_dtype``), read without loading the program."""
    with zipfile.ZipFile(io.BytesIO(data)) as z:
        names = [n for n in z.namelist() if n.endswith(_META)]
        if not names:
            raise ValueError("not an artifact of export_predict: it has no "
                             f"{_META}")
        return json.loads(z.read(names[0]))


def load_exported(data: bytes):
    """Deserialize an artifact of :func:`export_predict`.

    Returns ``call(images) -> (boxes, scores, labels, inds, valid)``;
    ``images`` must lie on the artifact's device and have its input shape.
    ``call.program`` is the ``ExportedProgram`` and ``call.meta`` the
    artifact's :func:`artifact_meta`.
    """
    from . import ops  # noqa: F401  (registers the custom ops of the graph)

    meta = artifact_meta(data)
    if meta["device"] == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the artifact was exported on a CUDA device and runs only on "
            "one; this machine has none")
    program = torch.export.load(io.BytesIO(data))
    module = program.module()

    @torch.no_grad()
    def call(images: torch.Tensor):
        return tuple(module(images))

    call.program = program
    call.meta = meta
    return call
