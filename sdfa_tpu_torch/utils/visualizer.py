"""Matplotlib plotting utilities (counterpart of
``sdfa_tpu/utils/visualizer.py``, copied).

Covers the surface of saber/data/visualizer/easy_plot.py — per-cell plot
descriptors with curve / (x, y) pair / heatmap-with-colorbar / RGB-image /
aligned-transcription / labeled-bars modes, a row×column grid with
per-cell colorbars, "auto"/"same" value-range unification, ``color_mapping``
(colormap → uint8 image), and figure→numpy / save helpers. Cells classify
themselves into a ``kind`` at construction and rendering dispatches through
a module-level renderer registry; the grid is laid out with a matplotlib
``GridSpec`` (alternating cell/colorbar columns).

``Transcription`` / ``Word`` are self-contained carriers with the
duck-typed surface the aligned-transcription renderer needs
(``transcript``, ``words[i].word/.start/.end``): the reference's import
target for that mode does not exist.

``color_mapping`` is ``viewer/video.py::color_mapping``, the port's one
colour map. Everything imports matplotlib inside its functions and forces
the Agg backend: these run headless (the summary plot plugins, evaluation
image tracks, dataset QA plots), and the package imports on a host without
matplotlib.
"""

from __future__ import annotations

import itertools
import math
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..viewer.video import color_mapping  # noqa: F401  (the port's one colour map)

DEFAULT_CMAP = "viridis"
DEFAULT_FONT_SIZE = 12

# cell geometry (inches); widths derive from the grid's data aspect
_CELL_H = 2.5
_BAR_FRAC = 0.04   # colorbar width as a fraction of its cell's width
_LABEL_SIZE = DEFAULT_FONT_SIZE * 0.8


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


# ---------------------------------------------------------------------------
# transcription carriers (duck-typed surface of the reference's missing
# forced_alignment.Transcription — word text + start/end seconds)


@dataclass
class Word:
    word: str
    start: float  # seconds
    end: float = 0.0


@dataclass
class Transcription:
    words: List[Word] = field(default_factory=list)

    @property
    def transcript(self) -> str:
        return " ".join(w.word for w in self.words)


# ---------------------------------------------------------------------------
# cells: data classified into a render kind at construction


_RENDERERS: Dict[str, Callable] = {}


def renderer(kind: str):
    """Register the draw routine for one cell kind: fn(cell, ax, cax)."""

    def deco(fn):
        _RENDERERS[kind] = fn
        return fn

    return deco


class plot_item(dict):
    """One grid cell. Dict-backed (attribute reads/writes mirror keys, and
    extra kwargs ride along for the renderer), but all classification
    happens here: the constructor normalizes the data and picks ``kind``,
    so rendering is a flat registry dispatch with no shape sniffing.

    Kinds: ``xy`` (two 1-d arrays), ``curve`` (one 1-d array), ``aligned``
    (1-d + transcription + sample rate), ``bars`` (1-d + labels +
    rectangle=True), ``heat`` (2-d, gets a colorbar), ``rgb`` (H×W×{3,4};
    C-first and single-channel inputs are coerced).
    """

    def __init__(self, item, title: str = "", vmin=None, vmax=None,
                 draw_fn=None, cmap: str = DEFAULT_CMAP, **kwargs):
        kind, item, span, lo, hi = self._classify(item, kwargs, title)
        super().__init__(
            item=item, title=title,
            title_lines=title.count("\n") + 1 if title else 0,
            vmin=lo if vmin is None else float(vmin),
            vmax=hi if vmax is None else float(vmax),
            x_length=span[0], y_length=span[1],
            kind=kind, draw_fn=draw_fn, cmap=cmap, **kwargs)
        if draw_fn is not None:
            assert callable(draw_fn), "draw_fn must be callable(cell, ax, cax)"

    @staticmethod
    def _classify(item, kwargs, title):
        """→ (kind, normalized item, (x_len, y_len), vmin, vmax)."""
        if isinstance(item, (list, tuple)):
            xs, ys = (np.asarray(a) for a in item)
            assert xs.ndim == ys.ndim == 1, "an (x, y) pair needs 1-d arrays"
            return ("xy", (xs, ys), (float(xs.max() - xs.min()), 1),
                    float(ys.min()), float(ys.max()))
        item = np.asarray(item)
        if item.ndim == 1:
            if kwargs.get("aligned_transcription") is not None and (
                    kwargs.get("sample_rate") or kwargs.get("sr")):
                kind = "aligned"
            elif kwargs.get("labels") is not None and kwargs.get("rectangle"):
                kind = "bars"
            else:
                kind = "curve"
            return (kind, item, (len(item), 1),
                    float(item.min()), float(item.max()))
        if item.ndim == 2:
            return ("heat", item, (item.shape[1], item.shape[0]),
                    float(item.min()), float(item.max()))
        if item.ndim == 3:
            if item.shape[0] in (1, 3, 4) and item.shape[-1] not in (3, 4):
                item = np.moveaxis(item, 0, -1)  # channels-first → last
            assert item.shape[-1] in (1, 3, 4), (
                f"invalid image shape of '{title}': {item.shape}")
            if item.shape[-1] == 1:
                item = np.repeat(item, 3, axis=-1)
            return ("rgb", item, (item.shape[1], item.shape[0]),
                    float(item.min()), float(item.max()))
        raise NotImplementedError(f"[plot_item]: {item.ndim}-d data")

    def __getattr__(self, attr):
        try:
            return self[attr]
        except KeyError:
            raise AttributeError(attr) from None

    def __setattr__(self, attr, value):
        self[attr] = value

    def draw(self, ax, cax):
        for a in (ax, cax):
            a.tick_params(labelsize=_LABEL_SIZE)
        fn = self["draw_fn"] or _RENDERERS[self["kind"]]
        fn(self, ax, cax)


# ---------------------------------------------------------------------------
# renderers


def _no_bar(cax):
    cax.axis("off")


def _staggered_marks(ax, positions, texts, lo, hi, *, color, style,
                     text_color=None, fontsize=None, levels=6):
    """Vertical marker lines with labels cycling over a ladder of y
    positions so adjacent labels don't overlap. Shared by the index-label
    and transcription renderers."""
    import matplotlib.lines as mlines

    span = hi - lo
    ladder = itertools.cycle(lo + span * (0.02 + 0.13 * np.arange(levels)))
    for x, txt in zip(positions, texts):
        ax.add_line(mlines.Line2D([x, x], [lo, hi], linewidth=1,
                                  linestyle=style, c=color, alpha=0.6))
        ax.text(x, next(ladder), txt, fontsize=fontsize or 8,
                color=text_color or "black")


@renderer("xy")
def _render_xy(cell, ax, cax):
    xs, ys = cell["item"]
    ax.set_title(cell["title"])
    ax.set_xlim(0, cell["x_length"])
    ax.set_ylim(cell["vmin"], cell["vmax"])
    ax.plot(xs, ys)
    _no_bar(cax)


@renderer("curve")
def _render_curve(cell, ax, cax):
    y = cell["item"]
    ax.set_title(cell["title"])
    ax.set_xlim(0, len(y))
    if cell["vmin"] != cell["vmax"]:
        ax.set_ylim(cell["vmin"], cell["vmax"])
    ax.plot(np.arange(len(y)), y)
    _no_bar(cax)


@renderer("heat")
def _render_heat(cell, ax, cax):
    ax.set_title(cell["title"])
    mesh = ax.imshow(cell["item"], vmin=cell["vmin"], vmax=cell["vmax"],
                     cmap=cell["cmap"], aspect="auto", origin="lower")
    ax.figure.colorbar(mesh, cax=cax)
    labels = cell.get("index_labels")
    if labels is not None:
        n = cell["x_length"]
        assert len(labels) == n, (
            f"data length is {n}, but {len(labels)} labels.")
        if cell.get("each_index"):
            keep = range(len(labels))
        else:  # mark only label *changes* (run starts)
            keep = [i for i, lab in enumerate(labels)
                    if i == 0 or lab != labels[i - 1] or not str(lab)]
        _staggered_marks(
            ax, list(keep), [str(labels[i]) for i in keep],
            0, cell["item"].shape[0],
            color=cell.get("line_color", "black"), style="-",
            text_color=cell.get("text_color", "white"))


@renderer("rgb")
def _render_rgb(cell, ax, cax):
    ax.set_title(cell["title"])
    ax.imshow(cell["item"])
    ax.axis("off")
    _no_bar(cax)


@renderer("aligned")
def _render_aligned(cell, ax, cax):
    """1-d signal with a word-aligned transcription strip: one dash-dot
    marker per word onset, '(i) word' labels on a staggered ladder."""
    sig = cell["item"]
    sr = cell.get("sample_rate") or cell.get("sr")
    tr = cell["aligned_transcription"]
    # duck typing on purpose — anything with .transcript and .words works
    title = (tr.transcript if not cell["title"]
             else f"{cell['title']}: {tr.transcript}")
    ax.set_title(title)
    ax.set_xlim(0, len(sig))
    ax.set_ylim(cell["vmin"], cell["vmax"])
    ax.plot(np.arange(len(sig)), sig)
    _staggered_marks(
        ax, [w.start * sr for w in tr.words],
        [f"({i}) {w.word}" for i, w in enumerate(tr.words)],
        cell["vmin"], cell["vmax"], color="g", style="-.",
        fontsize=DEFAULT_FONT_SIZE * 0.8)
    _no_bar(cax)


@renderer("bars")
def _render_bars(cell, ax, cax):
    vals = cell["item"]
    labels = cell["labels"]
    assert len(labels) == len(vals)
    ax.set_title(cell["title"])
    ax.set_ylim(cell["vmin"], cell["vmax"])
    ax.bar(np.arange(len(vals)), vals - cell["vmin"], width=0.8,
           bottom=cell["vmin"])
    ax.set_xticks(np.arange(len(vals)), labels=list(labels))
    for i, v in enumerate(vals):
        ax.annotate(f"{v:.2f}", (i - 0.3, cell["vmin"]), fontsize=8)
    _no_bar(cax)


# ---------------------------------------------------------------------------
# grid


class _GridLayout:
    """Rows of plot_items (a bare item is a 1-cell row); tracks the grid's
    max data extents and unifies value ranges across cells."""

    def __init__(self, items: Sequence):
        rows = [list(r) if isinstance(r, (list, tuple)) else [r]
                for r in items]
        for row in rows:
            for it in row:
                assert type(it) is plot_item, (
                    f"given item {type(it)} is not 'plot_item'")
        width = max(map(len, rows))
        self._grid = [row + [None] * (width - len(row)) for row in rows]
        self.max_xlen = max(it["x_length"] for it in self.items())
        self.max_ylen = max(it["y_length"] for it in self.items())

    def set_value_range(self, vmin, vmax, mode: str):
        assert mode in ("auto", "same")
        for it in self.items():
            if vmin is not None:
                it["vmin"] = vmin
            if vmax is not None:
                it["vmax"] = vmax
        if mode == "same":
            lo = min(it["vmin"] for it in self.items())
            hi = max(it["vmax"] for it in self.items())
            for it in self.items():
                it["vmin"], it["vmax"] = lo, hi

    def items(self):
        return (it for row in self._grid for it in row if it is not None)

    @property
    def rows(self):
        return len(self._grid)

    @property
    def cols(self):
        return len(self._grid[0])

    def __call__(self, r, c):
        return self._grid[r][c]


def _cell_width(aspect, x_length, y_length) -> float:
    """Cell width in inches from the aspect policy: "auto" follows the
    data aspect clamped to [1, 4]× the height; "wide" is 16:9; a number
    is an explicit width/height ratio."""
    if aspect == "auto":
        ratio = x_length / max(y_length, 1)
        return _CELL_H * min(4.0, max(1.0, ratio))
    if aspect == "wide":
        return _CELL_H * 16.0 / 9.0
    return _CELL_H * float(aspect)


def _make_grid_axes(plt, n_rows, n_cols, cell_w, extra_title_rows, scaling):
    """One GridSpec with alternating cell/colorbar columns; returns the
    figure and [(ax, cax)] per grid position."""
    from matplotlib.gridspec import GridSpec

    cell_h = _CELL_H * scaling
    cell_w = cell_w * scaling
    bar_w = cell_w * _BAR_FRAC
    fig_w = n_cols * (cell_w + bar_w) * 1.25 + 0.6
    fig_h = n_rows * cell_h * (1.35 + 0.12 * extra_title_rows) + 0.5
    fig = plt.figure(figsize=(fig_w, fig_h))
    gs = GridSpec(
        n_rows, 2 * n_cols, figure=fig,
        width_ratios=[cell_w, bar_w] * n_cols,
        wspace=0.15, hspace=0.55 + 0.2 * extra_title_rows,
        left=0.45 / fig_w, right=1 - 0.45 / fig_w,
        top=1 - 0.45 / fig_h, bottom=0.35 / fig_h)
    axes = [[(fig.add_subplot(gs[r, 2 * c]), fig.add_subplot(gs[r, 2 * c + 1]))
             for c in range(n_cols)] for r in range(n_rows)]
    return fig, axes


# ---------------------------------------------------------------------------
# public functions


def figure_to_numpy(fig) -> np.ndarray:
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())
    return buf[..., :3].copy()


def draw_figure(fig, file_path: Optional[str] = None) -> Optional[np.ndarray]:
    """Save to png (dirs auto-created, extension coerced) and/or convert to
    numpy. The reference's interactive show/onclick branch is dropped —
    this framework only renders headless."""
    plt = _plt()
    if file_path is not None:
        if not file_path.endswith(".png"):
            file_path += ".png"
        parent = os.path.dirname(file_path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        fig.savefig(file_path, format="png")
    data = figure_to_numpy(fig)
    plt.close(fig)
    return data


def _coerce_item(item) -> plot_item:
    if type(item) is plot_item:
        return item
    if isinstance(item, dict):
        spec = dict(item)
        return plot_item(spec.pop("data"), **spec)
    return plot_item(item)


def _is_xy_pair(r) -> bool:
    """A 2-tuple of 1-d arrays is an (x, y) curve, not a row of cells."""
    return (len(r) == 2 and all(
        isinstance(x, np.ndarray) and x.ndim == 1 for x in r))


def plot(*items, file_path=None, val_mode="auto", aspect="wide",
         suptitle="", vmin=None, vmax=None, fig_scaling=1) -> np.ndarray:
    """Grid plot: each positional arg is a row (list/tuple) or a single
    cell; cells are plot_items (bare arrays and {'data': ...} dicts are
    coerced). Returns the rendered figure as uint8 RGB."""
    assert aspect in ("auto", "wide") or not isinstance(aspect, str), (
        f"[plot]: 'aspect' should be 'auto' or 'wide' not {aspect}")
    plt = _plt()
    rows = [([_coerce_item(c) for c in r] if isinstance(r, (list, tuple))
             and not _is_xy_pair(r) else _coerce_item(r)) for r in items]
    grid = _GridLayout(rows)
    grid.set_value_range(vmin, vmax, mode=val_mode)
    extra_title_rows = max(
        (it["title_lines"] - 1 for it in grid.items()), default=0)
    fig, axes = _make_grid_axes(
        plt, grid.rows, grid.cols,
        _cell_width(aspect, grid.max_xlen, grid.max_ylen),
        extra_title_rows, fig_scaling or 1)
    for r in range(grid.rows):
        for c in range(grid.cols):
            ax, cax = axes[r][c]
            cell = grid(r, c)
            if cell is None:
                ax.axis("off")
                cax.axis("off")
            else:
                cell.draw(ax, cax)
    if suptitle:
        fig.suptitle(suptitle)
    return draw_figure(fig, file_path=file_path)


def plot_grid(items: List, cols: Optional[int] = None,
              **kwargs) -> np.ndarray:
    """Flat list of arrays/dicts → one grid image, auto-square by default."""
    n = len(items)
    cols = cols or int(math.ceil(math.sqrt(n)))
    rows = [[_coerce_item(it) for it in items[i:i + cols]]
            for i in range(0, n, cols)]
    return plot(*rows, **kwargs)
