"""A small raster plotter on PIL, in place of matplotlib.

The port draws every figure without matplotlib, which the card's host does
not have: one plot area with axes, drawn through PIL's ``ImageDraw`` and
numpy. It does what the package's figures need and no more: curves, an
alpha-blended scatter, stacked ``fill_between`` bands, a heat map through a
colormap (or an RGB raster under one), text, a legend, a colorbar, ticks
and labels in PIL's default font.

``Axes(width, height, xlim, ylim)`` is a plot area of ``width`` x
``height`` pixels. Data map linearly onto it (``to_px``): ``xlim`` from the
left edge to the right one, ``ylim = (bottom, top)`` from the bottom edge
to the top one, so ``(180, 0)`` puts 0 on top, as an image's rows. What is
drawn lands in the plot area and is clipped to it; ``render`` lays the
ticks, labels, title, legend and colorbar around it and returns the figure
as an (H, W, 3) uint8 array, and ``save`` writes it.

The two colormaps the package uses, matplotlib's ``inferno`` and ``Blues``,
are 256-entry uint8 tables (``matplotlib.colormaps[name](range(256),
bytes=True)``), looked up as matplotlib looks them up: the normalised value
v takes entry ``floor(256 v)``, clipped to [0, 255].
"""

from __future__ import annotations

import math

import numpy as np

_INFERNO = (
    "00000300000400000601000701010901010b02010e020210030212040314040316"
    "05041806041b07051d08061f0906210a07230b07260d08280e082a0f092d10092f"
    "120a32130a34140b36160b39170b3b190b3e1a0b401c0c431d0c451f0c47200c4a"
    "220b4c240b4e260b50270b52290b542b0a562d0a582e0a5a300a5c32095d34095f"
    "3509603709613909623b09643c09653e0966400966410967430a68450a69460a69"
    "480b6a4a0b6a4b0c6b4d0c6b4f0d6c500d6c520e6c530e6d550f6d570f6d58106d"
    "5a116d5b116e5d126e5f126e60136e62146e63146e65156e66156e68166e6a176e"
    "6b176e6d186e6e186e70196e72196d731a6d751b6d761b6d781c6d7a1c6d7b1d6c"
    "7d1d6c7e1e6c801f6b811f6b83206b85206a86216a88216a8922698b22698d2369"
    "8e24689024689125679325679526669626669827659928649b28649c29639e2963"
    "a02a62a12b61a32b61a42c60a62c5fa72d5fa92e5eab2e5dac2f5cae305baf315b"
    "b1315ab23259b43358b53357b73456b83556ba3655bb3754bd3753be3852bf3951"
    "c13a50c23b4fc43c4ec53d4dc73e4cc83e4bc93f4acb4049cc4148cd4247cf4446"
    "d04544d14643d24742d44841d54940d64a3fd74b3ed94d3dda4e3bdb4f3adc5039"
    "dd5238de5337df5436e05634e25733e35832e45a31e55b30e65c2ee65e2de75f2c"
    "e8612be9622aea6428eb6527ec6726ed6825ed6a23ee6c22ef6d21f06f1ff0701e"
    "f1721df2741cf2751af37719f37918f47a16f57c15f57e14f68012f68111f78310"
    "f7850ef8870df8880cf88a0bf98c09f98e08f99008fa9107fa9306fa9506fa9706"
    "fb9906fb9b06fb9d06fb9e07fba007fba208fba40afba60bfba80dfbaa0efbac10"
    "fbae12fbb014fbb116fbb318fbb51afbb71cfbb91efabb21fabd23fabf25fac128"
    "f9c32af9c52cf9c72ff8c931f8cb34f8cd37f7cf3af7d13cf6d33ff6d542f5d745"
    "f5d948f4db4bf4dc4ff3de52f3e056f3e259f2e45df2e660f1e864f1e968f1eb6c"
    "f1ed70f1ee74f1f079f1f27df2f381f2f485f3f689f4f78df5f891f6fa95f7fb99"
    "f9fc9dfafda0fcfea4"
)

_BLUES = (
    "f7fbfff6fafef5f9fef4f9fef3f8fdf3f8fdf2f7fdf1f7fdf0f6fceff6fceff5fc"
    "eef5fcedf4fbecf4fbecf3fbebf3fbeaf2fae9f2fae8f1fae8f1fae7f0f9e6f0f9"
    "e5eff9e4eff9e4eef8e3eef8e2edf8e1edf8e1ecf7e0ecf7dfebf7deebf7ddeaf6"
    "ddeaf6dce9f6dbe9f6dae8f5dae8f5d9e7f5d8e7f5d7e6f4d7e6f4d6e5f4d5e5f4"
    "d4e4f3d4e4f3d3e3f3d2e3f3d1e2f2d1e2f2d0e1f2cfe1f2cee0f1cee0f1cddff1"
    "ccdff1cbdef0cbdef0caddf0c9ddf0c8dcefc8dcefc7dbefc6dbefc5daeec4daee"
    "c3d9eec1d9edc0d8edbfd8ecbed7ecbcd7ebbbd6ebbad6eab9d5eab7d4eab6d4e9"
    "b5d3e9b4d3e8b2d2e8b1d2e7b0d1e7afd1e6add0e6acd0e6abcfe5aacfe5a8cee4"
    "a7cee4a6cde3a5cde3a3cce3a2cbe2a1cbe2a0cae19ecae19dc9e09bc8e09ac7e0"
    "98c7df97c6df95c5df93c4de92c3de90c2de8fc1dd8dc0dd8bc0dd8abfdc88bedc"
    "87bddc85bcdb83bbdb82badb80b9da7fb8da7db8d97bb7d97ab6d978b5d877b4d8"
    "75b3d873b2d772b1d770b1d76fb0d66dafd66baed66aadd569acd567abd466aad4"
    "65aad363a9d362a8d261a7d260a6d15ea5d15da4d05ca3d05aa3cf59a2cf58a1ce"
    "57a0ce559fcd549ecd539dcc519ccc509bcb4f9bcb4e9aca4c99ca4b98c94a97c9"
    "4896c84795c84694c74594c74393c64292c64191c54090c53f8fc43e8ec43d8dc3"
    "3c8cc33b8bc23a8ac13989c13888c03787c03585bf3484bf3383be3282be3181bd"
    "3080bd2f7fbc2e7ebc2d7dbb2c7cbb2b7bba2a7ab92979b92878b82777b82676b7"
    "2575b72474b62373b62272b52171b52070b41f6fb31e6eb21e6db21d6cb11c6bb0"
    "1b6aaf1a69ae1a68ae1967ad1866ac1765ab1764ab1663aa1562a91461a81360a7"
    "135fa7125ea6115da5105ca40f5ba30f5aa30e59a20d58a10c57a00c56a00b559f"
    "0a549e09539d08529c08519c08509a084f99084e97084c96084b94084a92084991"
    "08488f08478e08468c08458b084489084388084286084185084083083f82083e80"
    "083d7e083c7d083b7b083a7a08397808387708377508367408357208347108336f"
    "08326e08316c08306b"
)


def _table(hex_rgb) -> np.ndarray:
    table = np.frombuffer(bytes.fromhex("".join(hex_rgb)), np.uint8)
    return table.reshape(256, 3)


INFERNO = _table(_INFERNO)
BLUES = _table(_BLUES)
COLORMAPS = {"inferno": INFERNO, "Blues": BLUES}
# matplotlib's default colour cycle ("tab10")
CYCLE = ((31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40),
         (148, 103, 189), (140, 86, 75), (227, 119, 194), (127, 127, 127),
         (188, 189, 34), (23, 190, 207))
WHITE, BLACK = (255, 255, 255), (0, 0, 0)


def rgb(color) -> tuple:
    """An RGB triple of 0-255 ints from one, or from 0-1 floats."""
    if all(isinstance(c, float) for c in color):
        return tuple(int(round(255 * c)) for c in color[:3])
    return tuple(int(c) for c in color[:3])


def colormap_index(values: np.ndarray) -> np.ndarray:
    """Table entries of normalised values: ``floor(256 v)`` in [0, 255]."""
    return np.clip(np.floor(np.asarray(values, np.float64) * 256.0),
                   0, 255).astype(np.int64)


def normalise(values, vmin=None, vmax=None) -> np.ndarray:
    """``(values - vmin) / (vmax - vmin)`` in float64; the data's own
    minimum and maximum where not given, 0 where they are equal."""
    values = np.asarray(values, np.float64)
    vmin = float(values.min()) if vmin is None else float(vmin)
    vmax = float(values.max()) if vmax is None else float(vmax)
    if vmax == vmin:
        return np.zeros_like(values)
    return (values - vmin) / (vmax - vmin)


def apply_colormap(values, cmap: str = "inferno", vmin=None,
                   vmax=None) -> np.ndarray:
    """(..., ) values -> (..., 3) uint8 colours of ``cmap``."""
    return COLORMAPS[cmap][colormap_index(normalise(values, vmin, vmax))]


def nice_ticks(lo: float, hi: float) -> np.ndarray:
    """About five round tick values in [lo, hi]: steps of 1, 2, 2.5 or 5
    times a power of ten."""
    span = hi - lo
    if not span > 0:
        return np.array([lo])
    raw = span / 5
    mag = 10.0 ** math.floor(math.log10(raw))
    step = next(m * mag for m in (1.0, 2.0, 2.5, 5.0, 10.0) if m * mag >= raw)
    first = math.ceil(lo / step - 1e-9)
    last = math.floor(hi / step + 1e-9)
    return np.round(np.arange(first, last + 1) * step, 10)


def data_limits(*arrays) -> tuple:
    """(lo, hi) of the finite values with 5 % of their span on each side,
    as matplotlib's autoscaling pads them."""
    values = np.concatenate([np.asarray(a, np.float64).ravel()
                             for a in arrays])
    values = values[np.isfinite(values)]
    if not values.size:
        return 0.0, 1.0
    lo, hi = float(values.min()), float(values.max())
    pad = (hi - lo) * 0.05 if hi > lo else 0.5
    return lo - pad, hi + pad


def _font():
    from PIL import ImageFont

    return ImageFont.load_default()


def _text_size(s: str) -> tuple:
    from PIL import Image, ImageDraw

    box = ImageDraw.Draw(Image.new("RGB", (1, 1))).textbbox(
        (0, 0), s, font=_font())
    return box[2] - box[0], box[3] - box[1]


def _paste_text(img, xy, s: str, color, anchor: str = "la",
                rotation: int = 0) -> None:
    """Text at ``xy`` of ``img``; ``rotation`` 90 reads bottom to top.
    ``anchor``: PIL's two letters (horizontal l/m/r, vertical a/m/b) of the
    text's box, rotated with it."""
    from PIL import Image, ImageDraw

    if not rotation:
        ImageDraw.Draw(img).text(xy, s, fill=rgb(color), font=_font(),
                                 anchor=anchor)
        return
    w, h = _text_size(s)
    layer = Image.new("L", (w + 2, h + 4), 0)
    ImageDraw.Draw(layer).text((1, 1), s, fill=255, font=_font(),
                               anchor="lt")
    layer = layer.rotate(rotation, expand=True)
    lw, lh = layer.size
    x = xy[0] - {"l": 0, "m": lw // 2, "r": lw}[anchor[0]]
    y = xy[1] - {"a": 0, "t": 0, "m": lh // 2, "b": lh}[anchor[1]]
    img.paste(Image.new("RGB", layer.size, rgb(color)), (int(x), int(y)),
              layer)


class Axes:
    """One plot area and what is drawn around it (see the module's
    docstring)."""

    def __init__(self, width: int, height: int, xlim=(0.0, 1.0),
                 ylim=(0.0, 1.0), *, title=None, xlabel=None, ylabel=None):
        from PIL import Image

        self.width, self.height = int(width), int(height)
        self.xlim = (float(xlim[0]), float(xlim[1]))
        self.ylim = (float(ylim[0]), float(ylim[1]))
        self.title, self.xlabel, self.ylabel = title, xlabel, ylabel
        self.plot = Image.new("RGB", (self.width, self.height), WHITE)
        self.xticks = self.yticks = None   # (values, labels) where set
        self.xtick_rotation = 0
        self._legend, self._legend_loc = [], None
        self._colorbar = None
        self.origin = None

    # ------------------------------------------------------------ mapping
    def to_px(self, x, y) -> tuple:
        """Data -> float pixel coordinates in the plot area (x right, y
        down from its top-left corner)."""
        (x0, x1), (bottom, top) = self.xlim, self.ylim
        px = (np.asarray(x, np.float64) - x0) / (x1 - x0) * self.width
        py = (top - np.asarray(y, np.float64)) / (top - bottom) * self.height
        return px, py

    # ------------------------------------------------------------ drawing
    def line(self, xs, ys, color, width: int = 1, dash=None, label=None):
        """A polyline through the points, broken where a coordinate is not
        finite; ``dash``: (on, off) pixels."""
        from PIL import ImageDraw

        px, py = self.to_px(xs, ys)
        px, py = np.broadcast_arrays(px.ravel(), py.ravel())
        ok = np.isfinite(px) & np.isfinite(py)
        draw = ImageDraw.Draw(self.plot)
        starts = np.flatnonzero(ok & ~np.r_[False, ok[:-1]])
        ends = np.flatnonzero(ok & ~np.r_[ok[1:], False]) + 1
        for a, b in zip(starts, ends):
            pts = list(zip(px[a:b].tolist(), py[a:b].tolist()))
            if len(pts) < 2:
                continue
            if dash is None:
                draw.line(pts, fill=rgb(color), width=width)
                if width > 1:  # PIL's wide line may leave out a vertex's
                    draw.line(pts, fill=rgb(color))  # own pixel
                continue
            on, off = dash
            for (ax, ay), (bx, by) in zip(pts[:-1], pts[1:]):
                length = math.hypot(bx - ax, by - ay)
                t = 0.0
                while t < length:
                    t1 = min(t + on, length)
                    draw.line([(ax + (bx - ax) * t / length,
                                ay + (by - ay) * t / length),
                               (ax + (bx - ax) * t1 / length,
                                ay + (by - ay) * t1 / length)],
                              fill=rgb(color), width=width)
                    t = t1 + off
        if label is not None:
            self._legend.append((label, rgb(color)))

    def scatter(self, xs, ys, color, radius: int = 1, alpha: float = 1.0):
        """A disc of ``radius`` pixels at each point, composited over what
        is there ``alpha`` at a time: a pixel under k discs becomes
        ``bg (1 - alpha)^k + color (1 - (1 - alpha)^k)``."""
        from PIL import Image

        px, py = self.to_px(xs, ys)
        cx, cy = np.floor(px).ravel(), np.floor(py).ravel()
        ok = np.isfinite(cx) & np.isfinite(cy)
        cx, cy = cx[ok].astype(np.int64), cy[ok].astype(np.int64)
        counts = np.zeros((self.height, self.width))
        for dy in range(-radius, radius + 1):
            for dx in range(-radius, radius + 1):
                if dx * dx + dy * dy > radius * radius:
                    continue
                x, y = cx + dx, cy + dy
                keep = (x >= 0) & (x < self.width) & (y >= 0) \
                    & (y < self.height)
                np.add.at(counts, (y[keep], x[keep]), 1.0)
        cover = (1.0 - (1.0 - alpha) ** counts)[..., None]
        arr = np.asarray(self.plot, np.float64)
        arr = arr * (1.0 - cover) + np.asarray(rgb(color), np.float64) * cover
        self.plot = Image.fromarray(np.round(arr).astype(np.uint8))

    def fill_between(self, xs, y0, y1, color, label=None):
        """The band between two curves over the same xs, filled."""
        from PIL import ImageDraw

        xs = np.asarray(xs, np.float64)
        px, py = self.to_px(
            np.concatenate([xs, xs[::-1]]),
            np.concatenate([np.broadcast_to(y1, xs.shape),
                            np.broadcast_to(y0, xs.shape)[::-1]]))
        ImageDraw.Draw(self.plot).polygon(list(zip(px.tolist(), py.tolist())),
                                          fill=rgb(color))
        if label is not None:
            self._legend.append((label, rgb(color)))

    def image(self, values, cmap: str | None = None, vmin=None, vmax=None,
              alpha: float = 1.0):
        """A raster over the whole plot area: (h, w) values through
        ``cmap``, or (h, w, 3) uint8 RGB. Plot pixel (c, r) takes the
        raster's pixel (floor((c + 0.5) w / width), floor((r + 0.5) h /
        height)) — pixel for pixel where the sizes agree — blended
        ``alpha`` over what is there and rounded."""
        from PIL import Image

        values = np.asarray(values)
        colors = values if cmap is None else apply_colormap(values, cmap,
                                                            vmin, vmax)
        h, w = colors.shape[:2]
        rows = ((np.arange(self.height) + 0.5) * h / self.height).astype(
            np.int64)
        cols = ((np.arange(self.width) + 0.5) * w / self.width).astype(
            np.int64)
        colors = colors[rows][:, cols].astype(np.float64)
        if alpha < 1.0:
            below = np.asarray(self.plot, np.float64)
            colors = np.round(alpha * colors + (1.0 - alpha) * below)
        self.plot = Image.fromarray(colors.astype(np.uint8))

    def text(self, x, y, s: str, color=BLACK):
        """Text centred on a data point."""
        px, py = self.to_px(x, y)
        _paste_text(self.plot, (float(px), float(py)), s, color, "mm")

    def legend(self, loc: str = "upper right"):
        """Draw the labelled items' legend at ``loc`` ("upper right",
        "lower left", ...) of the plot area when rendering."""
        self._legend_loc = loc

    def colorbar(self, cmap: str, vmin: float, vmax: float):
        """A colour strip of ``cmap`` from ``vmin`` (bottom) to ``vmax``
        right of the plot area, with its ticks."""
        self._colorbar = (cmap, float(vmin), float(vmax))

    def set_xticks(self, values, labels, rotation: int = 0):
        self.xticks = (list(values), list(labels))
        self.xtick_rotation = rotation

    def set_yticks(self, values, labels):
        self.yticks = (list(values), list(labels))

    # ---------------------------------------------------------- rendering
    def _ticks(self, axis: str) -> list:
        """[(pixel offset along the axis, label)] inside the plot area."""
        given = self.xticks if axis == "x" else self.yticks
        lim = self.xlim if axis == "x" else self.ylim
        if given is None:
            values = nice_ticks(min(lim), max(lim))
            labels = [f"{v:g}" for v in values]
        else:
            values, labels = given
        if axis == "x":
            pos = self.to_px(np.asarray(values, np.float64), 0.0)[0]
            size = self.width
        else:
            pos = self.to_px(0.0, np.asarray(values, np.float64))[1]
            size = self.height
        return [(float(p), str(s)) for p, s in zip(pos, labels)
                if -0.5 <= p <= size + 0.5]

    def render(self) -> np.ndarray:
        from PIL import Image, ImageDraw

        pad, tick = 6, 4
        xt, yt = self._ticks("x"), self._ticks("y")
        xt_sizes = [_text_size(s) for _, s in xt] or [(0, 0)]
        if self.xtick_rotation:
            xt_h = max(w for w, _ in xt_sizes)
        else:
            xt_h = max(h for _, h in xt_sizes)
        yt_w = max([_text_size(s)[0] for _, s in yt] or [0])
        line_h = _text_size("Ag")[1]
        left = pad + (line_h + pad if self.ylabel else 0) + yt_w + tick + 2
        top = pad + (line_h + pad if self.title else 0)
        bottom = tick + 2 + xt_h + pad + (line_h + pad if self.xlabel else 0)
        right = pad + 4
        bar = None
        if self._colorbar is not None:
            cmap, vmin, vmax = self._colorbar
            ticks = nice_ticks(vmin, vmax)
            labels = [f"{v:g}" for v in ticks]
            bar_w = 16
            right += pad + bar_w + tick + 2 + max(
                _text_size(s)[0] for s in labels) + pad
            bar = (cmap, vmin, vmax, ticks, labels, bar_w)
        fig = Image.new("RGB", (left + self.width + right,
                                top + self.height + bottom), WHITE)
        fig.paste(self.plot, (left, top))
        self.origin = (left, top)  # the plot area's corner in the figure
        draw = ImageDraw.Draw(fig)
        x0, y0 = left, top
        x1, y1 = left + self.width - 1, top + self.height - 1
        # the frame sits on the plot area's outermost pixels' outside
        draw.rectangle([x0 - 1, y0 - 1, x1 + 1, y1 + 1], outline=BLACK)
        for p, s in xt:
            x = x0 + p
            draw.line([(x, y1 + 1), (x, y1 + 1 + tick)], fill=BLACK)
            if self.xtick_rotation:
                _paste_text(fig, (x, y1 + tick + 3), s, BLACK, "mt",
                            rotation=self.xtick_rotation)
            else:
                _paste_text(fig, (x, y1 + tick + 3), s, BLACK, "ma")
        for p, s in yt:
            y = y0 + p
            draw.line([(x0 - 1 - tick, y), (x0 - 1, y)], fill=BLACK)
            _paste_text(fig, (x0 - tick - 3, y), s, BLACK, "rm")
        if self.xlabel:
            _paste_text(fig, ((x0 + x1) / 2, fig.height - pad), self.xlabel,
                        BLACK, "mb")
        if self.ylabel:
            _paste_text(fig, (pad, (y0 + y1) / 2), self.ylabel, BLACK, "lm",
                        rotation=90)
        if self.title:
            _paste_text(fig, ((x0 + x1) / 2, pad), self.title, BLACK, "ma")
        if self._legend and self._legend_loc:
            self._draw_legend(fig, (x0, y0, x1, y1))
        if bar is not None:
            cmap, vmin, vmax, ticks, labels, bar_w = bar
            bx = x1 + 1 + pad
            strip = COLORMAPS[cmap][colormap_index(
                (self.height - 1 - np.arange(self.height) + 0.5)
                / self.height)]
            fig.paste(Image.fromarray(np.repeat(strip[:, None], bar_w, 1)),
                      (bx, y0))
            draw.rectangle([bx - 1, y0 - 1, bx + bar_w, y1 + 1],
                           outline=BLACK)
            span = vmax - vmin if vmax > vmin else 1.0
            for v, s in zip(ticks, labels):
                y = y1 - (v - vmin) / span * (self.height - 1)
                draw.line([(bx + bar_w, y), (bx + bar_w + tick, y)],
                          fill=BLACK)
                _paste_text(fig, (bx + bar_w + tick + 3, y), s, BLACK, "lm")
        return np.asarray(fig)

    def _draw_legend(self, fig, area) -> None:
        from PIL import ImageDraw

        x0, y0, x1, y1 = area
        line_h = _text_size("Ag")[1] + 4
        swatch = 18
        w = 8 + swatch + 6 + max(_text_size(s)[0] for s, _ in self._legend)
        h = 6 + line_h * len(self._legend)
        vert, horiz = self._legend_loc.split()
        lx = x0 + 6 if horiz == "left" else x1 - 6 - w
        ly = y0 + 6 if vert == "upper" else y1 - 6 - h
        draw = ImageDraw.Draw(fig)
        draw.rectangle([lx, ly, lx + w, ly + h], fill=WHITE,
                       outline=(204, 204, 204))
        for i, (s, color) in enumerate(self._legend):
            cy = ly + 3 + line_h * i + line_h / 2
            draw.rectangle([lx + 6, cy - 3, lx + 6 + swatch, cy + 3],
                           fill=color)
            _paste_text(fig, (lx + 8 + swatch + 4, cy), s, BLACK, "lm")

    def save(self, path: str) -> np.ndarray:
        """Render, write to ``path`` (format from its extension) and return
        the rendered array."""
        from PIL import Image

        out = self.render()
        Image.fromarray(out).save(path)
        return out
