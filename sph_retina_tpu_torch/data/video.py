"""Video in and out with nothing beyond numpy and PIL: Motion JPEG.

The port imports no OpenCV, and the card's host has neither torchvision nor
PyAV, so the demos read and write video here. Motion JPEG needs only a
container parser and a JPEG codec, and PIL has the codec (libjpeg-turbo).

``open_video(source)`` reads, as RGB uint8 ``(H, W, 3)`` frames:

- a RIFF AVI whose video stream is Motion JPEG (``strh`` handler or
  ``biCompression`` ``MJPG`` / ``jpeg``): frames in ``idx1`` order (its
  offsets counted from the ``movi`` list or from the file's start, whichever
  the first entry fits), or, without ``idx1``, by walking ``movi`` (``LIST
  rec `` groups, ``JUNK`` and OpenDML's ``ix##`` chunks skipped); OpenDML's
  ``AVIX`` segments after the first are walked too. fps is ``dwRate /
  dwScale`` of ``strh``, else ``avih``'s microseconds a frame;
- an ISO BMFF file (``.mp4`` / ``.mov``) whose video sample entry is
  Motion JPEG (``jpeg``, ``mjpa``, or ``mp4v`` whose ``esds`` names object
  type 0x6C): samples from ``stsz``, ``stco`` / ``co64`` and ``stsc``; fps
  from ``mdhd``'s time scale and ``stts``;
- an image PIL opens, each of its frames (an animated GIF): fps from its
  ``duration``;
- a directory of images, in sorted order.

Where a source states no rate, fps is 25.0 (the JAX tool's
``cap.get(cv2.CAP_PROP_FPS) or 25.0``). Anything else (other codecs,
stream URLs) raises ``UnsupportedVideo`` naming what it found, before a
frame is read.

``VideoWriter(path, fps, size)`` streams frames to disk, each a JPEG at
quality 95 (OpenCV's MJPEG writer's), keeping only the index in memory
(16 bytes a frame): ``.avi`` is RIFF AVI 1.0 with ``idx1`` and raises
rather than pass 1 GiB (no OpenDML is written; ``.mp4`` has no such
limit); ``.mp4`` / ``.mov`` is ``ftyp``, ``mdat`` (64-bit size), then
``moov`` with a ``jpeg`` sample entry and ``stts`` / ``stsc`` / ``stsz`` /
``stco`` (``co64`` past 4 GiB), brand ``isom`` or ``qt  ``. Headers are
patched at ``close()``.
"""

from __future__ import annotations

import io
import os
import struct
from fractions import Fraction
from typing import Callable, Iterator

import numpy as np

__all__ = ["UnsupportedVideo", "VideoReader", "VideoWriter", "decode_jpeg",
           "encode_jpeg", "open_video"]

DEFAULT_FPS = 25.0
JPEG_QUALITY = 95
AVI_LIMIT = 1 << 30  # AVI 1.0's RIFF; FFmpeg starts OpenDML's AVIX here
WHAT_IS_READ = ("the port reads Motion JPEG in AVI, MP4 or MOV, images PIL "
                "opens (each frame of an animated GIF) and directories of "
                "images")
MJPEG_FOURCCS = {"mjpg", "jpeg"}
MJPEG_SAMPLE_ENTRIES = {"jpeg", "mjpa"}
MP4_JPEG_OBJECT_TYPE = 0x6C
CODEC_NAMES = {  # what a refusal calls a fourcc or sample entry it knows
    "h264": "H.264", "x264": "H.264", "avc1": "H.264", "avc3": "H.264",
    "hev1": "H.265", "hvc1": "H.265", "hevc": "H.265", "h265": "H.265",
    "fmp4": "MPEG-4 Part 2", "xvid": "MPEG-4 Part 2",
    "divx": "MPEG-4 Part 2", "dx50": "MPEG-4 Part 2",
    "mp4v": "MPEG-4 Part 2", "mp4v/0x20": "MPEG-4 Part 2",
    "av01": "AV1", "vp08": "VP8", "vp80": "VP8", "vp09": "VP9",
    "vp90": "VP9", "mjpb": "Motion JPEG format B", "dib ": "uncompressed",
    "\0\0\0\0": "uncompressed",
}
IMAGE_SUFFIXES = (".bmp", ".gif", ".jpeg", ".jpg", ".pgm", ".png", ".ppm",
                  ".tif", ".tiff", ".webp")


class UnsupportedVideo(ValueError):
    """A source or an output the port's video layer does not handle."""


def decode_jpeg(payload: bytes) -> np.ndarray:
    """One JPEG -> RGB uint8 (H, W, 3), decoded by PIL."""
    from PIL import Image

    with Image.open(io.BytesIO(payload)) as im:
        return np.asarray(im.convert("RGB"))


def encode_jpeg(frame: np.ndarray, quality: int = JPEG_QUALITY) -> bytes:
    """RGB uint8 (H, W, 3) -> one JPEG, encoded by PIL."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(frame)).save(buf, "JPEG",
                                                      quality=quality)
    return buf.getvalue()


def _refuse(source, what: str) -> UnsupportedVideo:
    return UnsupportedVideo(f"{source}: {what}; {WHAT_IS_READ}")


def _codec(source, fourcc: str) -> UnsupportedVideo:
    name = CODEC_NAMES.get(fourcc.lower())
    return _refuse(source, f"codec {fourcc!r}"
                   + (f" ({name})" if name else "") + " is not Motion JPEG")


# --------------------------------------------------------------------------- #
# the reader
# --------------------------------------------------------------------------- #
class VideoReader:
    """The frames of one source, in order, as RGB uint8 (H, W, 3) arrays.

    ``fps``, ``frame_count`` and ``size`` (width, height, as the source
    states it) are known before the first frame is read."""

    def __init__(self, fps: float, size: tuple, items: list, load: Callable,
                 close: Callable | None = None):
        self.fps = float(fps)
        self.size = (int(size[0]), int(size[1]))
        self._items, self._load, self._close = items, load, close

    @property
    def frame_count(self) -> int:
        return len(self._items)

    def __iter__(self) -> Iterator[np.ndarray]:
        for item in self._items:
            yield self._load(item)

    def close(self) -> None:
        if self._close is not None:
            self._close()
            self._close = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open_video(source) -> VideoReader:
    """A reader of ``source``: a Motion-JPEG AVI / MP4 / MOV file, an image
    PIL opens, or a directory of images (see the module's docstring)."""
    source = os.fspath(source)
    if "://" in source:
        raise _refuse(source, "a stream URL is not read")
    if os.path.isdir(source):
        return _image_directory(source)
    if not os.path.isfile(source):
        raise FileNotFoundError(f"no such video: {source}")
    with open(source, "rb") as f:
        head = f.read(12)
    if head[:4] == b"RIFF" and head[8:12] == b"AVI ":
        return _open_avi(source)
    if head[4:8] in (b"ftyp", b"moov", b"mdat", b"wide", b"free", b"skip"):
        return _open_bmff(source)
    return _open_image(source)


def _spans_reader(source, fps, size, spans) -> VideoReader:
    """A reader of JPEG payloads at ``(offset, length)`` spans of a file."""
    f = open(source, "rb")

    def load(span):
        f.seek(span[0])
        return decode_jpeg(f.read(span[1]))

    return VideoReader(fps, size, spans, load, f.close)


def _fps(rate, scale) -> float | None:
    return rate / scale if rate and scale else None


# ----- AVI ----------------------------------------------------------------- #
def _chunks(f, start: int, end: int):
    """(fourcc, data offset, data size) of each chunk in [start, end); a
    LIST's data starts with its list type."""
    pos = start
    while pos + 8 <= end:
        f.seek(pos)
        head = f.read(8)
        if len(head) < 8:
            return
        cid, size = head[:4], struct.unpack("<I", head[4:])[0]
        yield cid, pos + 8, size
        pos += 8 + size + (size & 1)


def _walk_movi(f, start: int, end: int, ids: tuple, out: list) -> None:
    """Append the spans of the chunks named ``ids`` in a movi list, into
    ``LIST rec `` groups; everything else (``JUNK``, ``ix##``, other
    streams) is skipped."""
    for cid, pos, size in _chunks(f, start, end):
        if cid == b"LIST":
            f.seek(pos)
            if f.read(4) == b"rec ":
                _walk_movi(f, pos + 4, pos + size, ids, out)
        elif cid in ids and size:
            out.append((pos, size))


def _open_avi(source) -> VideoReader:
    with open(source, "rb") as f:
        file_end = f.seek(0, os.SEEK_END)
        riff_end = min(file_end, 8 + struct.unpack("<I", _at(f, 4, 4))[0])
        avih = strh = strf = None
        movi = []   # (data start after 'movi', end, start of 'movi')
        idx1 = None
        stream = video = -1
        for cid, pos, size in _chunks(f, 12, riff_end):
            if cid == b"LIST":
                kind = _at(f, pos, 4)
                if kind == b"hdrl":
                    for c2, p2, s2 in _chunks(f, pos + 4, pos + size):
                        if c2 == b"avih":
                            avih = _at(f, p2, min(s2, 56))
                        elif c2 == b"LIST" and _at(f, p2, 4) == b"strl":
                            stream += 1
                            h = f_ = None
                            for c3, p3, s3 in _chunks(f, p2 + 4, p2 + s2):
                                if c3 == b"strh":
                                    h = _at(f, p3, min(s3, 56))
                                elif c3 == b"strf":
                                    f_ = _at(f, p3, min(s3, 40))
                            if video < 0 and h is not None \
                                    and h[:4] == b"vids":
                                video, strh, strf = stream, h, f_
                elif kind == b"movi":
                    movi.append((pos + 4, pos + size, pos))
            elif cid == b"idx1":
                idx1 = (pos, size)
        # OpenDML: further RIFF 'AVIX' segments, each with a movi list
        pos = riff_end + (riff_end & 1)
        while pos + 12 <= file_end:
            cid, size = _at(f, pos, 4), struct.unpack("<I",
                                                      _at(f, pos + 4, 4))[0]
            if cid != b"RIFF" or _at(f, pos + 8, 4) != b"AVIX":
                break
            for c2, p2, s2 in _chunks(f, pos + 12, pos + 8 + size):
                if c2 == b"LIST" and _at(f, p2, 4) == b"movi":
                    movi.append((p2 + 4, p2 + s2, p2))
            pos += 8 + size + (size & 1)
        if strh is None or not movi:
            raise _refuse(source, "an AVI without a video stream")
        handler = strh[4:8].decode("latin-1")
        compression = strf[16:20].decode("latin-1") if strf and \
            len(strf) >= 20 else ""
        if handler.lower() not in MJPEG_FOURCCS \
                and compression.lower() not in MJPEG_FOURCCS:
            raise _codec(source, compression or handler)
        ids = (b"%02ddc" % video, b"%02ddb" % video)
        spans = []
        if idx1 is not None:
            spans = _idx1_spans(f, idx1, ids, movi[0][2], file_end)
        if not spans:
            _walk_movi(f, movi[0][0], movi[0][1], ids, spans)
        for start, end, _ in movi[1:]:
            _walk_movi(f, start, end, ids, spans)
    scale, rate = struct.unpack("<II", strh[20:28])
    usec = struct.unpack("<I", avih[:4])[0] if avih else 0
    fps = _fps(rate, scale) or (1e6 / usec if usec else DEFAULT_FPS)
    if strf and len(strf) >= 12:
        w, h = struct.unpack("<ii", strf[4:12])
    else:
        w, h = struct.unpack("<II", avih[32:40])
    return _spans_reader(source, fps, (w, abs(h)), spans)


def _at(f, pos: int, n: int) -> bytes:
    f.seek(pos)
    return f.read(n)


def _idx1_spans(f, idx1, ids, movi_fourcc: int, file_end: int) -> list:
    """The spans ``idx1`` lists for ``ids``, in its order. Offsets count
    from the ``movi`` fourcc, or from the file's start: the first entry
    decides, by where its chunk id is found."""
    data = _at(f, idx1[0], idx1[1])
    entries = [struct.unpack_from("<4sIII", data, i)
               for i in range(0, len(data) - 15, 16)]
    entries = [e for e in entries if e[0] in ids]
    if not entries:
        return []
    ckid, _, offset, _ = entries[0]
    base = 0
    if _at(f, movi_fourcc + offset, 4) == ckid:
        base = movi_fourcc
    elif _at(f, offset, 4) != ckid:
        return []  # an index that fits neither: walk the movi list
    return [(base + off + 8, size) for _, _, off, size in entries
            if size and base + off + 8 + size <= file_end]


# ----- ISO BMFF (MP4, MOV) ------------------------------------------------- #
BMFF_CONTAINERS = {b"moov", b"trak", b"mdia", b"minf", b"stbl", b"edts",
                   b"dinf"}


def _boxes(data: bytes, start: int, end: int):
    """(type, payload start, box end) of each box in data[start:end]."""
    pos = start
    while pos + 8 <= end:
        size, typ = struct.unpack_from(">I4s", data, pos)
        head = 8
        if size == 1:
            size, head = struct.unpack_from(">Q", data, pos + 8)[0], 16
        elif size == 0:
            size = end - pos
        if size < head:
            return
        yield typ, pos + head, min(pos + size, end)
        pos += size


def _top_level_moov(f, file_end: int) -> bytes:
    pos = 0
    while pos + 8 <= file_end:
        size, typ = struct.unpack(">I4s", _at(f, pos, 8))
        head = 8
        if size == 1:
            size, head = struct.unpack(">Q", _at(f, pos + 8, 8))[0], 16
        elif size == 0:
            size = file_end - pos
        if typ == b"moov":
            return _at(f, pos, size)
        if size < head:
            break
        pos += size
    return b""


def _descriptor(data: bytes, pos: int) -> tuple[int, int, int]:
    """(tag, payload start, payload end) of an MPEG-4 descriptor."""
    tag, pos, n = data[pos], pos + 1, 0
    for _ in range(4):
        b = data[pos]
        pos += 1
        n = (n << 7) | (b & 0x7F)
        if not b & 0x80:
            break
    return tag, pos, pos + n


def _esds_object_type(entry: bytes, start: int, end: int) -> int | None:
    """objectTypeIndication of the ``esds`` box among a sample entry's
    children."""
    for typ, p, e in _boxes(entry, start, end):
        if typ != b"esds":
            continue
        tag, p, e = _descriptor(entry, p + 4)  # after version and flags
        if tag != 0x03:
            return None
        flags = entry[p + 2]
        p += 3 + (2 if flags & 0x80 else 0)  # ES_ID, flags, dependsOn_ES_ID
        if flags & 0x40:
            p += 1 + entry[p]  # URL
        p += 2 if flags & 0x20 else 0  # OCR_ES_Id
        tag, p, _ = _descriptor(entry, p)
        return entry[p] if tag == 0x04 else None
    return None


def _open_bmff(source) -> VideoReader:
    with open(source, "rb") as f:
        file_end = f.seek(0, os.SEEK_END)
        moov = _top_level_moov(f, file_end)
    if not moov:
        raise _refuse(source, "an MP4 / MOV without a moov box")
    tracks, found = [], []

    def collect(start, end, track):
        for typ, p, e in _boxes(moov, start, end):
            if typ == b"trak":
                track = {}
                tracks.append(track)
            if typ in BMFF_CONTAINERS:
                collect(p, e, track)
            elif track is not None:  # mdia's hdlr, not minf's (QuickTime)
                track.setdefault(typ, (p, e))

    collect(0, len(moov), None)
    for t in tracks:
        if b"hdlr" in t and moov[t[b"hdlr"][0] + 8:
                                 t[b"hdlr"][0] + 12] == b"vide":
            found.append(t)
    if not found:
        raise _refuse(source, "an MP4 / MOV without a video track")
    t = found[0]
    p, e = t[b"stsd"]
    (typ, ep, ee), = list(_boxes(moov, p + 8, e))[:1]
    entry = typ.decode("latin-1")
    if entry == "mp4v":
        oti = _esds_object_type(moov, ep + 78, ee)
        if oti != MP4_JPEG_OBJECT_TYPE:
            raise _codec(source, "mp4v/0x%02X" % (oti or 0))
    elif entry.lower() not in MJPEG_SAMPLE_ENTRIES:
        raise _codec(source, entry)
    w, h = struct.unpack_from(">HH", moov, ep + 24)

    sizes = _sample_sizes(moov, t[b"stsz"])
    offsets = _chunk_offsets(moov, t)
    per_chunk = _samples_per_chunk(moov, t[b"stsc"], len(offsets))
    spans, k = [], 0
    for offset, n in zip(offsets, per_chunk):
        for _ in range(n):
            if k == len(sizes):
                break
            spans.append((offset, sizes[k]))
            offset += sizes[k]
            k += 1
    mdhd = t[b"mdhd"][0]
    if moov[mdhd] == 1:  # version 1: 64-bit times
        timescale = struct.unpack_from(">I", moov, mdhd + 20)[0]
    else:
        timescale = struct.unpack_from(">I", moov, mdhd + 12)[0]
    p, _ = t[b"stts"]
    n_runs = struct.unpack_from(">I", moov, p + 4)[0]
    runs = [struct.unpack_from(">II", moov, p + 8 + 8 * i)
            for i in range(n_runs)]
    ticks = sum(count * delta for count, delta in runs)
    frames = sum(count for count, _ in runs)
    fps = _fps(frames * timescale, ticks) or DEFAULT_FPS
    return _spans_reader(source, fps, (w, h), spans)


def _sample_sizes(moov: bytes, box) -> list:
    p, _ = box
    size, count = struct.unpack_from(">II", moov, p + 4)
    if size:
        return [size] * count
    return list(struct.unpack_from(f">{count}I", moov, p + 12))


def _chunk_offsets(moov: bytes, t: dict) -> list:
    if b"co64" in t:
        p, _ = t[b"co64"]
        n = struct.unpack_from(">I", moov, p + 4)[0]
        return list(struct.unpack_from(f">{n}Q", moov, p + 8))
    p, _ = t[b"stco"]
    n = struct.unpack_from(">I", moov, p + 4)[0]
    return list(struct.unpack_from(f">{n}I", moov, p + 8))


def _samples_per_chunk(moov: bytes, box, n_chunks: int) -> list:
    p, _ = box
    n = struct.unpack_from(">I", moov, p + 4)[0]
    runs = [struct.unpack_from(">III", moov, p + 8 + 12 * i)
            for i in range(n)]
    out = []
    for i, (first, per, _) in enumerate(runs):
        last = runs[i + 1][0] if i + 1 < n else n_chunks + 1
        out += [per] * max(0, last - first)
    return out


# ----- images -------------------------------------------------------------- #
def _open_image(source) -> VideoReader:
    from PIL import Image, UnidentifiedImageError

    try:
        im = Image.open(source)
    except UnidentifiedImageError:
        with open(source, "rb") as f:
            head = f.read(16)
        raise _refuse(source, f"neither AVI, MP4 / MOV nor an image "
                              f"(first bytes {head!r})") from None
    n = getattr(im, "n_frames", 1)
    duration = im.info.get("duration") or 0
    fps = 1000.0 / duration if duration else DEFAULT_FPS

    def load(i):
        im.seek(i)
        return np.asarray(im.convert("RGB"))

    return VideoReader(fps, im.size, list(range(n)), load, im.close)


def _image_directory(source) -> VideoReader:
    from PIL import Image

    names = sorted(n for n in os.listdir(source)
                   if n.lower().endswith(IMAGE_SUFFIXES)
                   and os.path.isfile(os.path.join(source, n)))
    if not names:
        raise _refuse(source, "a directory without images")
    paths = [os.path.join(source, n) for n in names]
    with Image.open(paths[0]) as im:
        size = im.size

    def load(path):
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))

    return VideoReader(DEFAULT_FPS, size, paths, load)


# --------------------------------------------------------------------------- #
# the writer
# --------------------------------------------------------------------------- #
def container_of(path) -> str:
    """``"avi"`` or ``"mp4"`` / ``"mov"`` by the suffix of ``path``; any
    other suffix raises ``UnsupportedVideo``."""
    suffix = os.path.splitext(os.fspath(path))[1].lower()
    if suffix not in (".avi", ".mp4", ".mov"):
        raise UnsupportedVideo(
            f"{path}: the port writes Motion JPEG into .avi, .mp4 or .mov, "
            f"not {suffix or 'a file without a suffix'}")
    return suffix[1:]


def _rate(fps: float) -> tuple[int, int]:
    """fps as (rate, scale): 30000/1001 for 29.97..., 25/1 for 25.0."""
    r = Fraction(fps).limit_denominator(1001)
    if r <= 0:
        raise ValueError(f"fps must be positive, not {fps}")
    return r.numerator, r.denominator


class VideoWriter:
    """Motion JPEG into ``.avi``, ``.mp4`` or ``.mov`` (by the suffix),
    ``size = (width, height)``, frames RGB uint8 (height, width, 3)."""

    def __init__(self, path, fps: float, size: tuple):
        self.container = container_of(path)
        self.path = os.fspath(path)
        self.size = (int(size[0]), int(size[1]))
        self.rate, self.scale = _rate(fps)
        self.fps = self.rate / self.scale
        self._sizes, self._offsets = [], []
        self._f = open(self.path, "wb")
        if self.container == "avi":
            self._f.write(self._avi_header())
            self._movi = self._f.tell() - 4  # the 'movi' fourcc
        else:
            brand = b"qt  " if self.container == "mov" else b"isom"
            compatible = brand + (b"" if brand == b"qt  " else b"iso2mp41")
            self._f.write(_box(b"ftyp", brand + struct.pack(">I", 0x200)
                               + compatible))
            self._mdat = self._f.tell()
            self._f.write(struct.pack(">I4sQ", 1, b"mdat", 16))

    def write(self, frame: np.ndarray) -> None:
        frame = np.asarray(frame)
        want = (self.size[1], self.size[0], 3)
        if frame.shape != want or frame.dtype != np.uint8:
            raise ValueError(f"a frame {frame.shape} {frame.dtype}, the "
                             f"video is {want} uint8")
        jpeg = encode_jpeg(frame)
        at = self._f.tell()
        if self.container == "avi":
            if at + 8 + len(jpeg) + 1 + 16 * (len(self._sizes) + 1) \
                    > AVI_LIMIT:
                raise OSError(f"{self.path}: an AVI 1.0 file ends at 1 GiB "
                              "(OpenDML is not written); write .mp4")
            self._f.write(b"00dc" + struct.pack("<I", len(jpeg)) + jpeg
                          + b"\0" * (len(jpeg) & 1))
        else:
            self._f.write(jpeg)
        self._offsets.append(at)
        self._sizes.append(len(jpeg))

    def close(self) -> None:
        if self._f is None:
            return
        try:
            if self.container == "avi":
                self._close_avi()
            else:
                self._close_bmff()
        finally:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ----- AVI ----- #
    def _avi_header(self) -> bytes:
        w, h = self.size
        n, largest = len(self._sizes), max(self._sizes, default=0)
        usec = round(1e6 * self.scale / self.rate)
        avih = struct.pack("<14I", usec, round(largest * self.fps), 0, 0x10,
                           n, 0, 1, largest + 8, w, h, 0, 0, 0, 0)
        strh = (b"vids" + b"MJPG" + struct.pack(
            "<IHHIIIIIIII4h", 0, 0, 0, 0, self.scale, self.rate, 0, n,
            largest + 8, 0xFFFFFFFF, 0, 0, 0, w, h))
        strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG",
                           w * h * 3, 0, 0, 0, 0)
        strl = _list(b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf))
        hdrl = _list(b"hdrl", _chunk(b"avih", avih) + strl)
        movi_size = 4 + sum(8 + s + (s & 1) for s in self._sizes)
        riff_size = 4 + len(hdrl) + 8 + movi_size + 8 + 16 * n
        return (b"RIFF" + struct.pack("<I", riff_size) + b"AVI " + hdrl
                + b"LIST" + struct.pack("<I", movi_size) + b"movi")

    def _close_avi(self) -> None:
        f = self._f
        f.write(b"idx1" + struct.pack("<I", 16 * len(self._sizes)))
        for offset, size in zip(self._offsets, self._sizes):
            f.write(b"00dc" + struct.pack("<III", 0x10, offset - self._movi,
                                          size))
        f.seek(0)
        f.write(self._avi_header())

    # ----- MP4 / MOV ----- #
    def _close_bmff(self) -> None:
        f = self._f
        end = f.tell()
        f.seek(self._mdat + 8)
        f.write(struct.pack(">Q", end - self._mdat))
        f.seek(end)
        f.write(self._moov())

    def _moov(self) -> bytes:
        w, h = self.size
        n = len(self._sizes)
        duration = n * self.scale  # in the media's time scale, self.rate
        matrix = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                             0x40000000)
        mvhd = _full(b"mvhd", struct.pack(">IIIIIH10x", 0, 0, self.rate,
                                          duration, 0x10000, 0x100)
                     + matrix + bytes(24) + struct.pack(">I", 2))
        tkhd = _full(b"tkhd", struct.pack(">IIIII8xhhH2x", 0, 0, 1, 0,
                                          duration, 0, 0, 0)
                     + matrix + struct.pack(">II", w << 16, h << 16), flags=3)
        mdhd = _full(b"mdhd", struct.pack(">IIIIHH", 0, 0, self.rate,
                                          duration, 0x55C4, 0))
        hdlr = _full(b"hdlr", struct.pack(">I4s12x", 0, b"vide")
                     + b"VideoHandler\0")
        name = b"Photo - JPEG"
        entry = _box(b"jpeg", bytes(6) + struct.pack(
            ">HHH12xHHIIIH", 1, 0, 0, w, h, 0x480000, 0x480000, 0, 1)
            + bytes([len(name)]) + name.ljust(31, b"\0")
            + struct.pack(">Hh", 24, -1))
        stsd = _full(b"stsd", struct.pack(">I", 1) + entry)
        stts = _full(b"stts", struct.pack(">III", 1, n, self.scale)
                     if n else struct.pack(">I", 0))
        stsc = _full(b"stsc", struct.pack(">IIII", 1, 1, 1, 1)
                     if n else struct.pack(">I", 0))
        stsz = _full(b"stsz", struct.pack(f">II{n}I", 0, n, *self._sizes))
        if max(self._offsets, default=0) < 1 << 32:
            stco = _full(b"stco", struct.pack(f">I{n}I", n, *self._offsets))
        else:
            stco = _full(b"co64", struct.pack(f">I{n}Q", n, *self._offsets))
        stbl = _box(b"stbl", stsd + stts + stsc + stsz + stco)
        dinf = _box(b"dinf", _full(b"dref", struct.pack(">I", 1)
                                   + _full(b"url ", b"", flags=1)))
        vmhd = _full(b"vmhd", bytes(8), flags=1)
        minf = _box(b"minf", vmhd + dinf + stbl)
        mdia = _box(b"mdia", mdhd + hdlr + minf)
        return _box(b"moov", mvhd + _box(b"trak", tkhd + mdia))


def _chunk(cid: bytes, data: bytes) -> bytes:
    return cid + struct.pack("<I", len(data)) + data + b"\0" * (len(data) & 1)


def _list(kind: bytes, data: bytes) -> bytes:
    return b"LIST" + struct.pack("<I", 4 + len(data)) + kind + data


def _box(typ: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + typ + payload


def _full(typ: bytes, payload: bytes, version: int = 0,
          flags: int = 0) -> bytes:
    return _box(typ, struct.pack(">I", version << 24 | flags) + payload)
