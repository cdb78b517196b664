"""Live camera demo: detect spherical boxes on a camera's frames.

    python -m sph_retina_tpu_torch.webcam_demo CONFIG [CHECKPOINT] \\
        --camera-id 0
    python -m sph_retina_tpu_torch.webcam_demo CONFIG [CHECKPOINT] \\
        --source pano.avi --out shots/ --max-frames 8 [--device cuda|cpu]

The twin of the JAX package's ``tools/webcam_demo.py``. The frames come
from ``/dev/video{--camera-id}`` through ``data/v4l2.py`` (the JAX tool's
``cv2.VideoCapture(camera_id)``), or from ``--source``: a ``/dev/video*``
path the same way, anything else through ``data/video.py:open_video``
(Motion JPEG in AVI, MP4 or MOV, an animated GIF, a directory of images;
no stream URL). Each frame is one ``inference_detector`` call, on the CUDA
device unless ``--device cpu`` is given, drawn by ``show_result``. With
``--out`` the drawn frames are written as ``DIR/frame_{n:06d}.jpg`` (PIL,
quality 95, as ``cv2.imwrite``'s default); without it they are shown in a
``tkinter`` window (``PIL.ImageTk``), where Esc or q quits. A window needs
``DISPLAY`` or ``WAYLAND_DISPLAY`` and ``tkinter``: elsewhere the demo
exits, before the model is built, saying to pass ``--out``. A source that
cannot be opened exits before the model is built too (the JAX tool builds
it first).
"""

from __future__ import annotations

import argparse
import os
import sys

from .apis import inference_detector, init_detector, show_result

WINDOW_TITLE = "sph_retina_tpu"
QUIT_KEYS = ("Escape", "q")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Spherical webcam demo")
    p.add_argument("config")
    p.add_argument("checkpoint", nargs="?", default=None)
    p.add_argument("--camera-id", type=int, default=0)
    p.add_argument("--source", default=None,
                   help="a video file, a directory of images or a "
                        "/dev/video* device instead of the camera")
    p.add_argument("--score-thr", type=float, default=0.3)
    p.add_argument("--out", default=None,
                   help="directory for annotated frames (headless mode; "
                        "no window is opened)")
    p.add_argument("--max-frames", type=int, default=0,
                   help="stop after N frames (0 = run until Esc/EOF)")
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="default: the CUDA device")
    return p.parse_args(argv)


def open_source(source, camera_id: int):
    """The frames of ``--source`` (a ``/dev/video*`` device or what
    ``open_video`` reads), else of camera ``camera_id``."""
    from .data.v4l2 import V4L2Camera
    from .data.video import open_video

    if source is None:
        return V4L2Camera(camera_id)
    if source.startswith("/dev/video"):
        return V4L2Camera(source)
    return open_video(source)


class Window:
    """A ``tkinter`` window that shows RGB frames; ``quit`` turns true at
    Esc, q or the window's close button."""

    def __init__(self, title: str = WINDOW_TITLE):
        import tkinter

        self.root = tkinter.Tk()
        self.root.title(title)
        self.label = tkinter.Label(self.root)
        self.label.pack()
        self.quit = False
        self.root.bind("<Key>", self._key)
        self.root.protocol("WM_DELETE_WINDOW", self._closed)

    def _key(self, event) -> None:
        if event.keysym in QUIT_KEYS:
            self.quit = True

    def _closed(self) -> None:
        self.quit = True

    def show(self, rgb) -> None:
        from PIL import Image, ImageTk

        photo = ImageTk.PhotoImage(Image.fromarray(rgb), master=self.root)
        self.label.configure(image=photo)
        self.label.image = photo  # tkinter keeps no reference of its own
        self.root.update()

    def close(self) -> None:
        self.root.destroy()


def window_unavailable() -> str | None:
    """Why no window can be opened here, or None."""
    if not (os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY")):
        return "neither DISPLAY nor WAYLAND_DISPLAY is set"
    try:
        import tkinter  # noqa: F401
        from PIL import ImageTk  # noqa: F401
    except ImportError as e:
        return f"no window toolkit ({e})"
    return None


def main(argv=None) -> int:
    args = parse_args(argv)
    if not args.out:
        why = window_unavailable()
        if why:
            raise SystemExit(f"cannot open a window: {why}; pass --out DIR "
                             "to write the annotated frames instead")
    frames = open_source(args.source, args.camera_id)
    try:
        det = init_detector(args.config, args.checkpoint,
                            device=args.device)
        n = _run(det, frames, args)
    finally:
        frames.close()
    print(f"{n} frames processed")
    return 0


def _run(det, frames, args) -> int:
    from PIL import Image

    window = None
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    else:
        window = Window()
    print("Press Esc/q to quit." if not args.out else
          f"Writing annotated frames to {args.out}", flush=True)
    n = 0
    try:
        for rgb in frames:
            result = inference_detector(det, rgb)
            drawn = show_result(det, rgb, result, score_thr=args.score_thr)
            n += 1
            if args.out:
                Image.fromarray(drawn).save(
                    os.path.join(args.out, f"frame_{n:06d}.jpg"), quality=95)
            else:
                window.show(drawn)
                if window.quit:
                    break
            if args.max_frames and n >= args.max_frames:
                break
    finally:
        if window is not None:
            window.close()
    return n


if __name__ == "__main__":
    sys.exit(main())
