"""The port's video layer (``data/video.py``, ``data/v4l2.py``) on the CPU,
against OpenCV, which only the tests import:

- the port reads what ``cv2.VideoWriter`` writes as Motion JPEG (``MJPG``
  into ``.avi``; into ``.mp4`` FFmpeg falls back to the ``mp4v`` sample
  entry with object type 0x6C, into ``.mov`` to ``jpeg``): frame count,
  size and fps those ``cv2.VideoCapture`` reports, each frame PIL's decode
  of the file's JPEG payload bit for bit (the payloads cut out of the bytes
  here, by their SOI and EOI markers), and within ``DECODER_TOLERANCE`` of
  cv2's own decode, which is FFmpeg's Motion-JPEG decoder and not
  libjpeg-turbo;
- cv2 reads the port's ``.avi``, ``.mp4`` and ``.mov`` (each first checked
  by a parser of the test's own: chunk and box sizes, even padding, index
  counts): count, size and fps equal, frames within the same tolerance;
  the port reads its own file as PIL decodes what it wrote, bit for bit;
- AVI variants cv2 does not write: no ``idx1``, ``idx1`` offsets from the
  file's start, ``LIST rec `` groups with ``JUNK``, and an OpenDML
  ``AVIX`` segment with an ``ix00`` index; an animated GIF and a directory
  of images;
- refusals by name: MPEG-4 Part 2 in ``.mp4`` and ``.avi`` (written by
  cv2), H.264 (the port's files with their codec renamed), a stream URL, a
  file that is no video, and a writer's unknown suffix;
- V4L2: the ioctl numbers against ``linux/videodev2.h``, the structures'
  sizes, the YUYV conversion bit for bit against ``cv2.cvtColor``, and
  ``cannot open camera 99``.

Every file written is removed at the end (C12).
"""

import ctypes
import os
import re
import shutil
import struct

import cv2
import numpy as np
import pytest
from PIL import Image, ImageFilter

from sph_retina_tpu_torch.data import VideoWriter, open_video, v4l2
from sph_retina_tpu_torch.data.video import (
    UnsupportedVideo,
    decode_jpeg,
    encode_jpeg,
)

H, W = 96, 192
N_FRAMES = 9
FPS = 30000 / 1001
# FFmpeg's Motion-JPEG decode against libjpeg-turbo's (PIL), on these
# smooth frames at 4:2:0, quality 95: they differ most at the painted
# patches' edges, where the chroma is upsampled differently (measured on
# these frames: max 37, mean 1.93 levels). Held a frame: mean absolute
# difference and PSNR.
DECODER_TOLERANCE = {"mean": 3.0, "psnr_db": 30.0}
HEADER = "/usr/include/linux/videodev2.h"


def _frames(n=N_FRAMES, h=H, w=W, seed=0):
    """Smooth seeded colour gradients with three painted patches, blurred:
    content like the demos' panoramas."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for _ in range(n):
        ph = rng.uniform(0, 2 * np.pi, 3)
        c = np.stack([127 + 100 * np.sin(2 * np.pi * xx / w + ph[0]),
                      127 + 100 * np.sin(2 * np.pi * yy / h + ph[1]),
                      127 + 100 * np.sin(2 * np.pi * (xx / w + yy / h)
                                         + ph[2])], -1).astype(np.uint8)
        for _ in range(3):
            y0, x0 = rng.integers(0, h - 20), rng.integers(0, w - 30)
            c[y0:y0 + 20, x0:x0 + 30] = rng.integers(0, 256, 3)
        out.append(np.asarray(Image.fromarray(c).filter(
            ImageFilter.GaussianBlur(2))))
    return out


def _cv2_write(path, fourcc, frames, fps=FPS):
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), fps,
                        (frames[0].shape[1], frames[0].shape[0]))
    assert w.isOpened()
    for f in frames:
        w.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    w.release()


def _cv2_read(path):
    cap = cv2.VideoCapture(path)
    assert cap.isOpened()
    meta = {"fps": cap.get(cv2.CAP_PROP_FPS),
            "frame_count": int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
            "size": (int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                     int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))}
    frames = []
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
    cap.release()
    return meta, frames


def _payloads(data: bytes) -> list:
    """The JPEGs in a file's bytes, cut at SOI and the EOI after it."""
    out = []
    for m in re.finditer(rb"\xff\xd8\xff", data):
        if out and m.start() < out[-1][1]:
            continue
        end = data.index(b"\xff\xd9", m.start()) + 2
        out.append((m.start(), end))
    return [data[a:b] for a, b in out]


def _within_decoder_tolerance(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = got.astype(np.float64) - want
    mse = float((diff ** 2).mean())
    psnr = 10 * np.log10(255.0 ** 2 / mse) if mse else np.inf
    assert np.abs(diff).mean() <= DECODER_TOLERANCE["mean"]
    assert psnr >= DECODER_TOLERANCE["psnr_db"]


# ----- the test's own structure checks ------------------------------------ #
def _riff(data: bytes, start: int, end: int):
    pos = start
    while pos + 8 <= end:
        cid, size = data[pos:pos + 4], struct.unpack_from("<I", data,
                                                          pos + 4)[0]
        yield cid, pos, size
        pos += 8 + size + (size & 1)
    assert pos == end, f"chunks end at {pos}, their list at {end}"


def _check_avi(data: bytes, n: int) -> dict:
    """Chunk sizes that tile the file, even padding, ``n`` frames in
    ``movi`` and in ``idx1``. Returns the places of ``movi`` and
    ``idx1``."""
    assert data[:4] == b"RIFF" and data[8:12] == b"AVI "
    assert struct.unpack_from("<I", data, 4)[0] == len(data) - 8
    places, frames = {}, 0
    for cid, pos, size in _riff(data, 12, len(data)):
        if cid == b"LIST" and data[pos + 8:pos + 12] == b"movi":
            places["movi"] = pos + 8
            for c2, p2, s2 in _riff(data, pos + 12, pos + 8 + size):
                assert c2 == b"00dc" and p2 % 2 == 0
                frames += 1
        elif cid == b"idx1":
            places["idx1"] = pos
            assert size == 16 * n
    assert frames == n
    return places


def _check_bmff(data: bytes, n: int) -> None:
    pos, kinds = 0, []
    while pos < len(data):
        size, typ = struct.unpack_from(">I4s", data, pos)
        if size == 1:
            size = struct.unpack_from(">Q", data, pos + 8)[0]
        kinds.append(typ)
        assert size >= 8
        pos += size
    assert pos == len(data) and kinds == [b"ftyp", b"mdat", b"moov"]
    stsz = data.index(b"stsz")
    assert struct.unpack_from(">I", data, stsz + 12)[0] == n


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("video")
    frames = _frames()
    paths = {}
    for name, fourcc in (("cv2_mjpg.avi", "MJPG"), ("cv2_mjpg.mp4", "MJPG"),
                         ("cv2_mjpg.mov", "MJPG"), ("cv2_mp4v.mp4", "mp4v"),
                         ("cv2_mp4v.avi", "mp4v")):
        paths[name] = str(tmp / name)
        _cv2_write(paths[name], fourcc, frames)
    for suffix in ("avi", "mp4", "mov"):
        paths[f"port.{suffix}"] = str(tmp / f"port.{suffix}")
        with VideoWriter(paths[f"port.{suffix}"], FPS, (W, H)) as w:
            for f in frames:
                w.write(f)
    yield {"tmp": tmp, "frames": frames, "paths": paths}
    shutil.rmtree(tmp, ignore_errors=True)


@pytest.mark.parametrize("name", ["cv2_mjpg.avi", "cv2_mjpg.mp4",
                                  "cv2_mjpg.mov"])
def test_the_port_reads_what_opencv_writes(media, name):
    path = media["paths"][name]
    meta, theirs = _cv2_read(path)
    with open(path, "rb") as f:
        payloads = _payloads(f.read())
    with open_video(path) as r:
        assert (r.fps, r.frame_count, r.size) == (
            meta["fps"], meta["frame_count"], meta["size"])
        mine = list(r)
    assert len(mine) == len(theirs) == len(payloads) == N_FRAMES
    for got, payload, want in zip(mine, payloads, theirs):
        np.testing.assert_array_equal(got, decode_jpeg(payload))
        _within_decoder_tolerance(got, want)


@pytest.mark.parametrize("suffix", ["avi", "mp4", "mov"])
def test_opencv_reads_what_the_port_writes(media, suffix):
    path = media["paths"][f"port.{suffix}"]
    with open(path, "rb") as f:
        data = f.read()
    if suffix == "avi":
        _check_avi(data, N_FRAMES)
    else:
        _check_bmff(data, N_FRAMES)
    written = [encode_jpeg(f) for f in media["frames"]]
    assert _payloads(data) == written
    meta, theirs = _cv2_read(path)
    with open_video(path) as r:
        assert (r.fps, r.frame_count, r.size) == (FPS, N_FRAMES, (W, H))
        mine = list(r)
    assert (meta["fps"], meta["frame_count"], meta["size"]) == (
        FPS, N_FRAMES, (W, H))
    assert len(theirs) == N_FRAMES
    for got, payload, want, source in zip(mine, written, theirs,
                                          media["frames"]):
        np.testing.assert_array_equal(got, decode_jpeg(payload))
        _within_decoder_tolerance(got, want)
        _within_decoder_tolerance(got, source)


def _movi_list(items: list) -> bytes:
    body = b"movi" + b"".join(items)
    return b"LIST" + struct.pack("<I", len(body)) + body


def _chunk(cid: bytes, data: bytes) -> bytes:
    return cid + struct.pack("<I", len(data)) + data + b"\0" * (len(data) & 1)


def _with_riff_size(data: bytes) -> bytes:
    return data[:4] + struct.pack("<I", len(data) - 8) + data[8:]


def _avi_variant(base: bytes, jpegs: list, kind: str) -> bytes:
    """The port's AVI of ``jpegs`` rewritten into a layout cv2 does not
    write."""
    places = _check_avi(base, len(jpegs))
    movi, idx1 = places["movi"], places["idx1"]  # the 'movi' fourcc
    if kind == "no_idx1":
        return _with_riff_size(base[:idx1])
    if kind == "absolute_idx1":
        out = bytearray(base)
        for i in range(len(jpegs)):
            at = idx1 + 8 + 16 * i + 8
            off = struct.unpack_from("<I", out, at)[0]
            struct.pack_into("<I", out, at, off + movi)
        return bytes(out)
    frames = [_chunk(b"00dc", j) for j in jpegs]
    if kind == "rec_and_junk":
        rec = lambda items: _chunk(b"LIST", b"rec " + b"".join(items))
        items = [_chunk(b"JUNK", bytes(13)), rec(frames[:3]),
                 _chunk(b"01wb", bytes(7)), *frames[3:5],
                 _chunk(b"JUNK", bytes(4)), rec(frames[5:])]
        return _with_riff_size(base[:movi - 8] + _movi_list(items))
    assert kind == "opendml"
    # the first 4 frames under RIFF 'AVI ' with idx1, the rest in an AVIX
    # segment with a standard index chunk, which the reader skips
    head = base[:movi - 8] + _movi_list(frames[:4])
    entries, pos = b"", 4
    for j in jpegs[:4]:
        entries += b"00dc" + struct.pack("<III", 0x10, pos, len(j))
        pos += 8 + len(j) + (len(j) & 1)
    first = _with_riff_size(head + _chunk(b"idx1", entries))
    ix00 = _chunk(b"ix00", struct.pack("<HBBI4sQI", 2, 0, 1, 5, b"00dc", 0,
                                       0) + bytes(40))
    avix = _chunk(b"RIFF", b"AVIX" + _movi_list([ix00, *frames[4:]]))
    return first + avix


@pytest.mark.parametrize("kind", ["no_idx1", "absolute_idx1", "rec_and_junk",
                                  "opendml"])
def test_avi_layouts_cv2_does_not_write(media, kind):
    with open(media["paths"]["port.avi"], "rb") as f:
        base = f.read()
    jpegs = [encode_jpeg(f) for f in media["frames"]]
    path = str(media["tmp"] / f"{kind}.avi")
    with open(path, "wb") as f:
        f.write(_avi_variant(base, jpegs, kind))
    with open_video(path) as r:
        assert (r.fps, r.frame_count, r.size) == (FPS, N_FRAMES, (W, H))
        for got, j in zip(r, jpegs):
            np.testing.assert_array_equal(got, decode_jpeg(j))
    os.remove(path)


def test_an_animated_gif_and_a_directory_of_images(media):
    frames = [np.asarray(Image.fromarray(f).quantize(64).convert("RGB"))
              for f in media["frames"][:5]]
    gif = str(media["tmp"] / "anim.gif")
    Image.fromarray(frames[0]).save(
        gif, save_all=True, append_images=[Image.fromarray(f)
                                           for f in frames[1:]],
        duration=40, loop=0)
    with Image.open(gif) as im, open_video(gif) as r:
        assert (r.fps, r.frame_count, r.size) == (25.0, 5, (W, H))
        for i, got in enumerate(r):
            im.seek(i)
            np.testing.assert_array_equal(got, np.asarray(im.convert("RGB")))
    folder = media["tmp"] / "shots"
    folder.mkdir()
    for i in (3, 0, 2, 1):  # written out of order, read sorted
        Image.fromarray(media["frames"][i]).save(folder / f"f_{i:02d}.png")
    (folder / "notes.txt").write_text("not an image")
    with open_video(str(folder)) as r:
        assert (r.fps, r.frame_count, r.size) == (25.0, 4, (W, H))
        for got, want in zip(r, media["frames"]):
            np.testing.assert_array_equal(got, want)
    os.remove(gif)
    shutil.rmtree(folder)


def _renamed_codec(data: bytes, suffix: str) -> bytes:
    if suffix == "avi":  # the handler and biCompression
        return data.replace(b"MJPG", b"H264")
    at = data.rindex(b"jpeg")  # the sample entry, in moov after mdat
    return data[:at] + b"avc1" + data[at + 4:]


@pytest.mark.parametrize("case, says", [
    ("cv2_mp4v.mp4", "'mp4v/0x20' (MPEG-4 Part 2)"),
    ("cv2_mp4v.avi", "'mp4v' (MPEG-4 Part 2)"),
    ("h264.avi", "'H264' (H.264)"),
    ("h264.mp4", "'avc1' (H.264)"),
    ("url", "a stream URL is not read"),
    ("noise.bin", "neither AVI, MP4 / MOV nor an image"),
])
def test_refusals_name_what_they_found(media, case, says):
    path = media["paths"].get(case)
    if case.startswith("h264"):
        suffix = case.split(".")[1]
        with open(media["paths"][f"port.{suffix}"], "rb") as f:
            data = _renamed_codec(f.read(), suffix)
        path = str(media["tmp"] / case)
        with open(path, "wb") as f:
            f.write(data)
    elif case == "url":
        path = "rtsp://localhost:8554/pano"
    elif case == "noise.bin":
        path = str(media["tmp"] / case)
        with open(path, "wb") as f:
            f.write(np.random.default_rng(0).bytes(256))
    with pytest.raises(UnsupportedVideo) as err:
        open_video(path)
    assert says in str(err.value) and "Motion JPEG" in str(err.value)
    if case.startswith(("h264", "noise")):
        os.remove(path)


@pytest.mark.parametrize("name", ["out.mkv", "out.gif", "out"])
def test_the_writer_refuses_other_suffixes(media, name):
    path = media["tmp"] / name
    with pytest.raises(UnsupportedVideo, match=".avi, .mp4 or .mov"):
        VideoWriter(str(path), FPS, (W, H))
    assert not path.exists()


# ----- V4L2 ---------------------------------------------------------------- #
IOCTLS = {"VIDIOC_QUERYCAP": 0x80685600, "VIDIOC_G_FMT": 0xC0D05604,
          "VIDIOC_S_FMT": 0xC0D05605, "VIDIOC_REQBUFS": 0xC0145608,
          "VIDIOC_QUERYBUF": 0xC0585609, "VIDIOC_QBUF": 0xC058560F,
          "VIDIOC_DQBUF": 0xC0585611, "VIDIOC_STREAMON": 0x40045612,
          "VIDIOC_STREAMOFF": 0x40045613}
DIRECTIONS = {"_IOR": 2, "_IOW": 1, "_IOWR": 3}


@pytest.mark.parametrize("name", sorted(IOCTLS))
def test_v4l2_ioctl_numbers(name):
    """The module's literal, the number ``linux/videodev2.h`` gives on
    x86-64, and, where the header is installed, ``_IOC(dir, 'V', nr,
    sizeof)`` of its definition with the size of the port's structure of
    that name."""
    got = getattr(v4l2, name)
    assert got == IOCTLS[name]
    if not os.path.exists(HEADER):
        return
    with open(HEADER) as f:
        text = f.read()
    m = re.search(rf"#define\s+{name}\s+(_IOW?R?)\('V',\s*(\d+),\s*"
                  rf"(struct (\w+)|int)\)", text)
    direction, nr, what, struct_name = m.groups()
    size = ctypes.sizeof(ctypes.c_int if what == "int"
                         else getattr(v4l2, struct_name))
    assert got == (DIRECTIONS[direction] << 30 | size << 16 | ord("V") << 8
                   | int(nr))


def test_v4l2_structures():
    """x86-64's sizes, and the offsets of the fields the camera reads."""
    sizes = {v4l2.v4l2_capability: 104, v4l2.v4l2_format: 208,
             v4l2.v4l2_requestbuffers: 20, v4l2.v4l2_buffer: 88,
             v4l2.v4l2_pix_format: 48}
    assert {s: ctypes.sizeof(s) for s in sizes} == sizes
    assert v4l2.v4l2_format.fmt.offset == 8
    assert (v4l2.v4l2_buffer.timestamp.offset, v4l2.v4l2_buffer.m.offset,
            v4l2.v4l2_buffer.length.offset) == (24, 64, 72)
    assert (v4l2.V4L2_PIX_FMT_MJPEG, v4l2.V4L2_PIX_FMT_YUYV) == (
        0x47504A4D, 0x56595559)


@pytest.mark.parametrize("shape", [(2, 4), (37, 64), (480, 640)])
def test_yuyv_to_rgb_is_opencvs(shape):
    packed = np.random.default_rng(shape[0]).integers(
        0, 256, (*shape, 2), dtype=np.uint8)
    np.testing.assert_array_equal(
        v4l2.yuyv_to_rgb(packed),
        cv2.cvtColor(packed, cv2.COLOR_YUV2RGB_YUYV))


def test_a_missing_camera_exits_as_the_jax_tool():
    with pytest.raises(SystemExit, match="^cannot open camera 99$"):
        v4l2.V4L2Camera(99)
