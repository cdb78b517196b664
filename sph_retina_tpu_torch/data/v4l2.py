"""A V4L2 camera on Linux: the twin of ``cv2.VideoCapture(camera_id)``.

``V4L2Camera(N)`` opens ``/dev/videoN`` with ``fcntl.ioctl`` and ``mmap``:
it queries the device's capabilities (video capture and streaming I/O),
keeps its current frame size (``VIDIOC_G_FMT``) and sets the pixel format,
Motion JPEG first and YUYV where the driver refuses it, requests 4 mmap
buffers, queues them and starts streaming. Iterating dequeues one frame at
a time, converts it to RGB uint8 (H, W, 3) and queues its buffer again: a
Motion-JPEG frame is decoded by PIL, a YUYV frame converted with OpenCV's
``COLOR_YUV2RGB_YUYV`` arithmetic (``yuyv_to_rgb``). A device that is
missing or cannot be opened raises the JAX tool's ``SystemExit("cannot
open camera N")``.

The ioctl numbers are literals, those ``linux/videodev2.h`` gives on
x86-64 (``sizeof(struct v4l2_format)`` 208, ``struct v4l2_buffer`` 88).
Neither machine the port is tested on has a camera, so the streaming
itself has not been run; the constants, the structures' sizes and the
YUYV conversion are what the tests hold.
"""

from __future__ import annotations

import ctypes
import errno
import mmap
import os
import select

import numpy as np

VIDIOC_QUERYCAP = 0x80685600
VIDIOC_G_FMT = 0xC0D05604
VIDIOC_S_FMT = 0xC0D05605
VIDIOC_REQBUFS = 0xC0145608
VIDIOC_QUERYBUF = 0xC0585609
VIDIOC_QBUF = 0xC058560F
VIDIOC_DQBUF = 0xC0585611
VIDIOC_STREAMON = 0x40045612
VIDIOC_STREAMOFF = 0x40045613

V4L2_BUF_TYPE_VIDEO_CAPTURE = 1
V4L2_MEMORY_MMAP = 1
V4L2_FIELD_ANY = 0
V4L2_CAP_VIDEO_CAPTURE = 0x00000001
V4L2_CAP_STREAMING = 0x04000000
V4L2_CAP_DEVICE_CAPS = 0x80000000
N_BUFFERS = 4
FRAME_TIMEOUT_S = 5.0


def fourcc(code: str) -> int:
    """``v4l2_fourcc``: four characters, little-endian."""
    a, b, c, d = (ord(ch) for ch in code)
    return a | b << 8 | c << 16 | d << 24


V4L2_PIX_FMT_MJPEG = fourcc("MJPG")
V4L2_PIX_FMT_YUYV = fourcc("YUYV")


class v4l2_capability(ctypes.Structure):
    _fields_ = [("driver", ctypes.c_char * 16), ("card", ctypes.c_char * 32),
                ("bus_info", ctypes.c_char * 32),
                ("version", ctypes.c_uint32),
                ("capabilities", ctypes.c_uint32),
                ("device_caps", ctypes.c_uint32),
                ("reserved", ctypes.c_uint32 * 3)]


class v4l2_pix_format(ctypes.Structure):
    _fields_ = [(name, ctypes.c_uint32) for name in (
        "width", "height", "pixelformat", "field", "bytesperline",
        "sizeimage", "colorspace", "priv", "flags", "ycbcr_enc",
        "quantization", "xfer_func")]


class _format_union(ctypes.Union):
    # struct v4l2_window holds pointers: the union is 8-byte aligned
    _fields_ = [("pix", v4l2_pix_format), ("raw_data", ctypes.c_uint8 * 200),
                ("_align", ctypes.c_void_p)]


class v4l2_format(ctypes.Structure):
    _fields_ = [("type", ctypes.c_uint32), ("fmt", _format_union)]


class v4l2_requestbuffers(ctypes.Structure):
    _fields_ = [("count", ctypes.c_uint32), ("type", ctypes.c_uint32),
                ("memory", ctypes.c_uint32),
                ("capabilities", ctypes.c_uint32),
                ("flags", ctypes.c_uint8), ("reserved", ctypes.c_uint8 * 3)]


class timeval(ctypes.Structure):
    _fields_ = [("tv_sec", ctypes.c_long), ("tv_usec", ctypes.c_long)]


class v4l2_timecode(ctypes.Structure):
    _fields_ = [("type", ctypes.c_uint32), ("flags", ctypes.c_uint32),
                ("frames", ctypes.c_uint8), ("seconds", ctypes.c_uint8),
                ("minutes", ctypes.c_uint8), ("hours", ctypes.c_uint8),
                ("userbits", ctypes.c_uint8 * 4)]


class _buffer_m(ctypes.Union):
    _fields_ = [("offset", ctypes.c_uint32), ("userptr", ctypes.c_ulong),
                ("planes", ctypes.c_void_p), ("fd", ctypes.c_int32)]


class v4l2_buffer(ctypes.Structure):
    _fields_ = [("index", ctypes.c_uint32), ("type", ctypes.c_uint32),
                ("bytesused", ctypes.c_uint32), ("flags", ctypes.c_uint32),
                ("field", ctypes.c_uint32), ("timestamp", timeval),
                ("timecode", v4l2_timecode), ("sequence", ctypes.c_uint32),
                ("memory", ctypes.c_uint32), ("m", _buffer_m),
                ("length", ctypes.c_uint32), ("reserved2", ctypes.c_uint32),
                ("request_fd", ctypes.c_int32)]


# OpenCV's ITU-R BT.601 fixed point (modules/imgproc/src/color_yuv.simd.hpp)
ITUR_BT_601_CY = 1220542
ITUR_BT_601_CUB = 2116026
ITUR_BT_601_CUG = -409993
ITUR_BT_601_CVG = -852492
ITUR_BT_601_CVR = 1673527
ITUR_BT_601_SHIFT = 20


def yuyv_to_rgb(packed: np.ndarray) -> np.ndarray:
    """YUYV 4:2:2, (H, W, 2) uint8 (Y0 U Y1 V a pixel pair), -> RGB uint8
    (H, W, 3), as ``cv2.cvtColor(packed, cv2.COLOR_YUV2RGB_YUYV)``."""
    pairs = packed.reshape(packed.shape[0], -1, 4).astype(np.int64)
    y = np.maximum(pairs[..., 0::2] - 16, 0) * ITUR_BT_601_CY  # Y0, Y1
    u = pairs[..., 1:2] - 128
    v = pairs[..., 3:4] - 128
    half = 1 << (ITUR_BT_601_SHIFT - 1)
    r = y + half + ITUR_BT_601_CVR * v
    g = y + half + ITUR_BT_601_CVG * v + ITUR_BT_601_CUG * u
    b = y + half + ITUR_BT_601_CUB * u
    rgb = np.stack([r, g, b], -1) >> ITUR_BT_601_SHIFT  # (H, W/2, 2, 3)
    return np.clip(rgb, 0, 255).astype(np.uint8).reshape(
        packed.shape[0], packed.shape[1], 3)


def _ioctl(fd: int, request: int, arg) -> None:
    import fcntl

    while True:
        try:
            fcntl.ioctl(fd, request, arg, True)
            return
        except InterruptedError:
            continue


class V4L2Camera:
    """Frames of ``/dev/video{camera_id}`` (or a ``/dev/video*`` path) as
    RGB uint8 (H, W, 3), one a ``next``; ``size`` is (width, height)."""

    def __init__(self, camera):
        path = camera if isinstance(camera, str) else f"/dev/video{camera}"
        self.path = path
        self.fd, self._maps = None, []
        try:
            self.fd = os.open(path, os.O_RDWR | os.O_NONBLOCK)
            self._start()
        except OSError:
            self.close()
            raise SystemExit(f"cannot open camera {camera}") from None

    def _start(self) -> None:
        cap = v4l2_capability()
        _ioctl(self.fd, VIDIOC_QUERYCAP, cap)
        caps = cap.device_caps if cap.capabilities & V4L2_CAP_DEVICE_CAPS \
            else cap.capabilities
        if not caps & V4L2_CAP_VIDEO_CAPTURE or not caps & V4L2_CAP_STREAMING:
            raise OSError(errno.ENODEV, "not a streaming capture device")
        fmt = v4l2_format(type=V4L2_BUF_TYPE_VIDEO_CAPTURE)
        _ioctl(self.fd, VIDIOC_G_FMT, fmt)
        width, height = fmt.fmt.pix.width, fmt.fmt.pix.height
        for pixelformat in (V4L2_PIX_FMT_MJPEG, V4L2_PIX_FMT_YUYV):
            fmt = v4l2_format(type=V4L2_BUF_TYPE_VIDEO_CAPTURE)
            fmt.fmt.pix.width, fmt.fmt.pix.height = width, height
            fmt.fmt.pix.pixelformat = pixelformat
            fmt.fmt.pix.field = V4L2_FIELD_ANY
            _ioctl(self.fd, VIDIOC_S_FMT, fmt)
            if fmt.fmt.pix.pixelformat == pixelformat:
                break
        else:
            raise OSError(errno.EINVAL, "neither MJPG nor YUYV is offered")
        self.pixelformat = fmt.fmt.pix.pixelformat
        self.size = (fmt.fmt.pix.width, fmt.fmt.pix.height)
        self.bytesperline = fmt.fmt.pix.bytesperline or 2 * self.size[0]
        req = v4l2_requestbuffers(count=N_BUFFERS,
                                  type=V4L2_BUF_TYPE_VIDEO_CAPTURE,
                                  memory=V4L2_MEMORY_MMAP)
        _ioctl(self.fd, VIDIOC_REQBUFS, req)
        for index in range(req.count):
            buf = self._buffer(index)
            _ioctl(self.fd, VIDIOC_QUERYBUF, buf)
            self._maps.append(mmap.mmap(self.fd, buf.length, mmap.MAP_SHARED,
                                        mmap.PROT_READ | mmap.PROT_WRITE,
                                        offset=buf.m.offset))
            _ioctl(self.fd, VIDIOC_QBUF, buf)
        _ioctl(self.fd, VIDIOC_STREAMON,
               ctypes.c_int(V4L2_BUF_TYPE_VIDEO_CAPTURE))

    @staticmethod
    def _buffer(index: int = 0) -> v4l2_buffer:
        return v4l2_buffer(index=index, type=V4L2_BUF_TYPE_VIDEO_CAPTURE,
                           memory=V4L2_MEMORY_MMAP)

    def read(self) -> np.ndarray:
        """The next frame; ``OSError`` where none comes within
        ``FRAME_TIMEOUT_S``."""
        if not select.select([self.fd], [], [], FRAME_TIMEOUT_S)[0]:
            raise OSError(errno.ETIMEDOUT, f"{self.path}: no frame")
        buf = self._buffer()
        _ioctl(self.fd, VIDIOC_DQBUF, buf)
        data = self._maps[buf.index][:buf.bytesused]
        _ioctl(self.fd, VIDIOC_QBUF, buf)
        if self.pixelformat == V4L2_PIX_FMT_MJPEG:
            from .video import decode_jpeg

            return decode_jpeg(data)
        w, h = self.size
        rows = np.frombuffer(data, np.uint8)[:h * self.bytesperline]
        return yuyv_to_rgb(rows.reshape(h, self.bytesperline)[:, :2 * w]
                           .reshape(h, w, 2))

    def __iter__(self):
        while True:
            yield self.read()

    def close(self) -> None:
        if self.fd is None:
            return
        if self._maps:
            try:
                _ioctl(self.fd, VIDIOC_STREAMOFF,
                       ctypes.c_int(V4L2_BUF_TYPE_VIDEO_CAPTURE))
            except OSError:
                pass
            for m in self._maps:
                m.close()
            self._maps = []
        os.close(self.fd)
        self.fd = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
