"""Reusable UI component library: the JAX package's ``ui/components.py``,
the same host code (reference deeplearning4j-ui-components:
org.deeplearning4j.ui.components — ChartLine / ChartScatter /
ChartHistogram / ChartStackedArea / ChartTimeline, ComponentTable / Text
/ Div, Style classes, all JSON-serializable for a front end to render).

Every component serializes to the reference-style ``{"componentType":
..., ...}`` JSON and renders server-side to self-contained HTML / SVG (no
client JS library), as the rest of ``ui/`` does. Components compose via
ComponentDiv; ``component_from_json(c.to_json())`` reconstructs the tree
(a registry keyed on componentType).
"""

from __future__ import annotations

import html as _html
import json
import re as _re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Type

#: categorical default palette (reference StyleChart's default series
#: colors play this role)
PALETTE = ["#3366cc", "#dc3912", "#ff9900", "#109618", "#990099",
           "#0099c6", "#dd4477", "#66aa00"]

_REGISTRY: Dict[str, Type["Component"]] = {}


def register_component(cls):
    _REGISTRY[cls.__name__] = cls
    return cls


#: CSS color tokens (#hex / names) — style values render into SVG
#: attributes, and component JSON may come from external front ends, so
#: anything else is replaced (markup injection guard; text content is
#: escaped separately)
_SAFE_COLOR = _re.compile(r"^(#[0-9a-fA-F]{3,8}|[a-zA-Z]{1,30})$")


def _safe_color(value: str, fallback: str) -> str:
    return value if _SAFE_COLOR.match(str(value)) else fallback


@dataclass
class Style:
    """Subset of the reference's StyleChart/StyleDiv/StyleTable surface
    that the renderers consume. Color values are validated against a CSS
    color pattern at construction — style JSON is as untrusted as the
    rest of the component tree."""
    width: int = 640
    height: int = 260
    background: str = "#ffffff"
    series_colors: Sequence[str] = field(default_factory=lambda: PALETTE)
    margin: int = 36

    def __post_init__(self):
        self.width = int(self.width)
        self.height = int(self.height)
        self.margin = int(self.margin)
        self.background = _safe_color(self.background, "#ffffff")
        self.series_colors = [_safe_color(c, PALETTE[i % len(PALETTE)])
                              for i, c in enumerate(self.series_colors)] \
            or PALETTE

    def to_dict(self):
        return {"width": self.width, "height": self.height,
                "background": self.background,
                "seriesColors": list(self.series_colors),
                "margin": self.margin}

    @classmethod
    def from_dict(cls, d):
        if not d:
            return cls()
        return cls(width=d.get("width", 640), height=d.get("height", 260),
                   background=d.get("background", "#ffffff"),
                   series_colors=d.get("seriesColors", PALETTE),
                   margin=d.get("margin", 36))


class Component:
    """Base: to_json/render contract (reference Component.java role)."""

    def __init__(self, style: Optional[Style] = None):
        self.style = style or Style()

    # -- serde ----------------------------------------------------------
    def to_dict(self) -> dict:
        return {"componentType": type(self).__name__,
                "style": self.style.to_dict()}

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    # -- rendering ------------------------------------------------------
    def render(self) -> str:
        raise NotImplementedError

    # -- svg helpers ----------------------------------------------------
    def _legend(self, i: int, name: str, color: str) -> str:
        return (f'<text x="{self.style.width - 120}" y="{16 + 13 * i}" '
                f'font-size="11" fill="{color}">'
                f'{_html.escape(name)}</text>')

    def _title(self, title: str) -> str:
        if not title:
            return ""
        return (f'<text x="{self.style.margin}" y="14" font-size="12" '
                f'font-weight="bold">{_html.escape(title)}</text>')

    def _frame(self, body: str) -> str:
        s = self.style
        return (f'<svg xmlns="http://www.w3.org/2000/svg" '
                f'width="{s.width}" height="{s.height}" '
                f'style="background:{s.background}">{body}</svg>')

    def _scales(self, xmin, xmax, ymin, ymax):
        s = self.style
        xspan = (xmax - xmin) or 1.0
        yspan = (ymax - ymin) or 1.0
        px = lambda x: s.margin + (x - xmin) / xspan * \
            (s.width - 2 * s.margin)
        py = lambda y: s.height - s.margin - (y - ymin) / yspan * \
            (s.height - 2 * s.margin)
        return px, py

    def _axes(self, xmin, xmax, ymin, ymax) -> str:
        s, m = self.style, self.style.margin
        fmt = lambda v: f"{v:.4g}"
        return (
            f'<line x1="{m}" y1="{s.height - m}" x2="{s.width - m}" '
            f'y2="{s.height - m}" stroke="#999"/>' +
            f'<line x1="{m}" y1="{m}" x2="{m}" y2="{s.height - m}" '
            f'stroke="#999"/>' +
            f'<text x="{m}" y="{s.height - m + 14}" font-size="10">'
            f'{fmt(xmin)}</text>' +
            f'<text x="{s.width - m - 30}" y="{s.height - m + 14}" '
            f'font-size="10">{fmt(xmax)}</text>' +
            f'<text x="{2}" y="{s.height - m}" font-size="10">'
            f'{fmt(ymin)}</text>' +
            f'<text x="{2}" y="{m + 4}" font-size="10">{fmt(ymax)}</text>')


def _series_bounds(series):
    xs = [x for _, sx, _ in series for x in sx]
    ys = [y for _, _, sy in series for y in sy]
    if not xs:
        return 0.0, 1.0, 0.0, 1.0
    return min(xs), max(xs), min(ys), max(ys)


@register_component
class ChartLine(Component):
    """Multi-series line chart (reference ChartLine.java)."""

    def __init__(self, title: str = "", style: Optional[Style] = None):
        super().__init__(style)
        self.title = title
        self.series: List = []          # (name, xs, ys)

    def add_series(self, name: str, x: Sequence[float],
                   y: Sequence[float]) -> "ChartLine":
        if len(x) != len(y):
            raise ValueError(f"series {name!r}: {len(x)} xs vs {len(y)} ys")
        self.series.append((name, [float(v) for v in x],
                            [float(v) for v in y]))
        return self

    def to_dict(self):
        d = super().to_dict()
        d["title"] = self.title
        d["series"] = [{"name": n, "x": xs, "y": ys}
                       for n, xs, ys in self.series]
        return d

    @classmethod
    def from_dict(cls, d):
        c = cls(d.get("title", ""), Style.from_dict(d.get("style")))
        for s in d.get("series", []):
            c.add_series(s["name"], s["x"], s["y"])
        return c

    def render(self) -> str:
        xmin, xmax, ymin, ymax = _series_bounds(self.series)
        px, py = self._scales(xmin, xmax, ymin, ymax)
        body = self._axes(xmin, xmax, ymin, ymax)
        colors = self.style.series_colors
        for i, (name, xs, ys) in enumerate(self.series):
            pts = " ".join(f"{px(x):.1f},{py(y):.1f}"
                           for x, y in zip(xs, ys))
            color = colors[i % len(colors)]
            body += (f'<polyline points="{pts}" fill="none" '
                     f'stroke="{color}" stroke-width="1.5"/>')
            body += self._legend(i, name, color)
        body += self._title(self.title)
        return self._frame(body)


@register_component
class ChartScatter(ChartLine):
    """Scatter chart (reference ChartScatter.java) — same series model,
    point marks instead of a polyline."""

    def render(self) -> str:
        xmin, xmax, ymin, ymax = _series_bounds(self.series)
        px, py = self._scales(xmin, xmax, ymin, ymax)
        body = self._axes(xmin, xmax, ymin, ymax)
        colors = self.style.series_colors
        for i, (name, xs, ys) in enumerate(self.series):
            color = colors[i % len(colors)]
            body += "".join(
                f'<circle cx="{px(x):.1f}" cy="{py(y):.1f}" r="2.5" '
                f'fill="{color}"/>' for x, y in zip(xs, ys))
            body += self._legend(i, name, color)
        body += self._title(self.title)
        return self._frame(body)


@register_component
class ChartHistogram(Component):
    """Histogram (reference ChartHistogram.java): explicit bin edges +
    counts, like the reference's lowerBounds/upperBounds/yValues."""

    def __init__(self, title: str = "", style: Optional[Style] = None):
        super().__init__(style)
        self.title = title
        self.bins: List = []            # (lower, upper, count)

    def add_bin(self, lower: float, upper: float,
                count: float) -> "ChartHistogram":
        self.bins.append((float(lower), float(upper), float(count)))
        return self

    def to_dict(self):
        d = super().to_dict()
        d["title"] = self.title
        d["lowerBounds"] = [b[0] for b in self.bins]
        d["upperBounds"] = [b[1] for b in self.bins]
        d["yValues"] = [b[2] for b in self.bins]
        return d

    @classmethod
    def from_dict(cls, d):
        c = cls(d.get("title", ""), Style.from_dict(d.get("style")))
        for lo, hi, y in zip(d.get("lowerBounds", []),
                             d.get("upperBounds", []),
                             d.get("yValues", [])):
            c.add_bin(lo, hi, y)
        return c

    def render(self) -> str:
        if not self.bins:
            return self._frame("")
        xmin = min(b[0] for b in self.bins)
        xmax = max(b[1] for b in self.bins)
        ymax = max(b[2] for b in self.bins) or 1.0
        px, py = self._scales(xmin, xmax, 0.0, ymax)
        body = self._axes(xmin, xmax, 0.0, ymax)
        color = self.style.series_colors[0]
        for lo, hi, y in self.bins:
            x0, x1 = px(lo), px(hi)
            y0 = py(y)
            body += (f'<rect x="{x0:.1f}" y="{y0:.1f}" '
                     f'width="{max(x1 - x0 - 1, 1):.1f}" '
                     f'height="{max(py(0) - y0, 0):.1f}" fill="{color}" '
                     f'fill-opacity="0.8"/>')
        body += self._title(self.title)
        return self._frame(body)


@register_component
class ChartStackedArea(ChartLine):
    """Stacked area chart (reference ChartStackedArea.java): series share
    one x grid; each band stacks on the previous sum."""

    def render(self) -> str:
        if not self.series:
            return self._frame("")
        xs = self.series[0][1]
        sums = [0.0] * len(xs)
        stacked = []
        for name, sx, sy in self.series:
            if len(sy) != len(xs):
                raise ValueError("stacked series must share the x grid")
            sums = [a + b for a, b in zip(sums, sy)]
            stacked.append((name, list(sums)))
        xmin, xmax = min(xs), max(xs)
        ymax = max(sums) or 1.0
        px, py = self._scales(xmin, xmax, 0.0, ymax)
        body = self._axes(xmin, xmax, 0.0, ymax)
        colors = self.style.series_colors
        prev = [0.0] * len(xs)
        for i, (name, tops) in enumerate(stacked):
            up = " ".join(f"{px(x):.1f},{py(y):.1f}"
                          for x, y in zip(xs, tops))
            down = " ".join(f"{px(x):.1f},{py(y):.1f}"
                            for x, y in zip(reversed(xs), reversed(prev)))
            color = colors[i % len(colors)]
            body += (f'<polygon points="{up} {down}" fill="{color}" '
                     f'fill-opacity="0.55" stroke="{color}"/>')
            body += self._legend(i, name, color)
            prev = tops
        body += self._title(self.title)
        return self._frame(body)


@register_component
class ChartTimeline(Component):
    """Timeline lanes (reference ChartTimeline.java): named lanes of
    (start, end, label) entries — the Spark phase-timing visual."""

    def __init__(self, title: str = "", style: Optional[Style] = None):
        super().__init__(style)
        self.title = title
        self.lanes: List = []           # (lane_name, [(t0, t1, label)])

    def add_lane(self, name: str, entries) -> "ChartTimeline":
        self.lanes.append((name, [(float(a), float(b), str(lbl))
                                  for a, b, lbl in entries]))
        return self

    def to_dict(self):
        d = super().to_dict()
        d["title"] = self.title
        d["lanes"] = [{"name": n,
                       "entries": [{"start": a, "end": b, "label": lbl}
                                   for a, b, lbl in es]}
                      for n, es in self.lanes]
        return d

    @classmethod
    def from_dict(cls, d):
        c = cls(d.get("title", ""), Style.from_dict(d.get("style")))
        for lane in d.get("lanes", []):
            c.add_lane(lane["name"], [(e["start"], e["end"], e["label"])
                                      for e in lane["entries"]])
        return c

    def render(self) -> str:
        entries = [e for _, es in self.lanes for e in es]
        if not entries:
            return self._frame("")
        t0 = min(a for a, _, _ in entries)
        t1 = max(b for _, b, _ in entries)
        px, _ = self._scales(t0, t1, 0, 1)
        s = self.style
        lane_h = max((s.height - 2 * s.margin) // max(len(self.lanes), 1),
                     14)
        body = ""
        colors = s.series_colors
        for i, (name, entries) in enumerate(self.lanes):
            y = s.margin + i * lane_h
            body += (f'<text x="2" y="{y + lane_h / 2 + 4}" '
                     f'font-size="10">{_html.escape(name)}</text>')
            for j, (a, b, lbl) in enumerate(entries):
                color = colors[j % len(colors)]
                body += (f'<rect x="{px(a):.1f}" y="{y}" '
                         f'width="{max(px(b) - px(a), 1):.1f}" '
                         f'height="{lane_h - 3}" fill="{color}" '
                         f'fill-opacity="0.8">'
                         f'<title>{_html.escape(lbl)}</title></rect>')
        body += self._title(self.title)
        return self._frame(body)


@register_component
class ComponentText(Component):
    def __init__(self, text: str = "", style: Optional[Style] = None):
        super().__init__(style)
        self.text = text

    def to_dict(self):
        d = super().to_dict()
        d["text"] = self.text
        return d

    @classmethod
    def from_dict(cls, d):
        return cls(d.get("text", ""), Style.from_dict(d.get("style")))

    def render(self) -> str:
        return f"<p>{_html.escape(self.text)}</p>"


@register_component
class ComponentTable(Component):
    def __init__(self, header: Optional[Sequence[str]] = None,
                 rows: Optional[Sequence[Sequence]] = None,
                 style: Optional[Style] = None):
        super().__init__(style)
        self.header = list(header or [])
        self.rows = [list(r) for r in (rows or [])]

    def to_dict(self):
        d = super().to_dict()
        d["header"] = self.header
        d["content"] = [[str(c) for c in r] for r in self.rows]
        return d

    @classmethod
    def from_dict(cls, d):
        return cls(d.get("header"), d.get("content"),
                   Style.from_dict(d.get("style")))

    def render(self) -> str:
        head = "".join(f"<th>{_html.escape(str(h))}</th>"
                       for h in self.header)
        body = "".join(
            "<tr>" + "".join(f"<td>{_html.escape(str(c))}</td>"
                             for c in row) + "</tr>"
            for row in self.rows)
        return (f'<table border="1" cellspacing="0" cellpadding="4">'
                f"<tr>{head}</tr>{body}</table>")


@register_component
class ComponentDiv(Component):
    """Container (reference ComponentDiv.java): children render in order."""

    def __init__(self, children: Optional[List[Component]] = None,
                 style: Optional[Style] = None):
        super().__init__(style)
        self.children = list(children or [])

    def add(self, child: Component) -> "ComponentDiv":
        self.children.append(child)
        return self

    def to_dict(self):
        d = super().to_dict()
        d["components"] = [c.to_dict() for c in self.children]
        return d

    @classmethod
    def from_dict(cls, d):
        return cls([_component_from_dict(c)
                    for c in d.get("components", [])],
                   Style.from_dict(d.get("style")))

    def render(self) -> str:
        inner = "".join(c.render() for c in self.children)
        return f"<div>{inner}</div>"


def _component_from_dict(d: dict) -> Component:
    kind = d.get("componentType")
    cls = _REGISTRY.get(kind)
    if cls is None:
        raise ValueError(f"unknown componentType {kind!r} "
                         f"(known: {sorted(_REGISTRY)})")
    return cls.from_dict(d)


def component_from_json(blob: str) -> Component:
    """Reconstruct a component tree from its JSON (reference front-end
    contract)."""
    return _component_from_dict(json.loads(blob))


def render_page(component: Component, title: str = "DL4J") -> str:
    """Self-contained HTML page around a component tree."""
    return (f"<!doctype html><html><head><meta charset='utf-8'>"
            f"<title>{_html.escape(title)}</title></head>"
            f"<body style='font-family:sans-serif'>{component.render()}"
            f"</body></html>")
