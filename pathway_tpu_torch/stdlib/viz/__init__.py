"""``pw.viz`` (reference ``stdlib/viz/``: Bokeh/Panel live plots).

When Bokeh is installed, ``plot`` drives a user plotting function over a
live ColumnDataSource like the reference.  Without it (this
environment), ``plot`` still produces a REAL artifact: a live,
dependency-free SVG chart — line series per numeric column over the
sorting column — rendered through ``_repr_html_`` (notebooks), ``to_svg``
and ``save_html``.  ``table_viz``/``show`` provide the live table widget.
"""

from __future__ import annotations

import html as _html
from typing import Any, Callable

import pathway_tpu_torch as pw
from pathway_tpu_torch.internals.table import Table

__all__ = ["plot", "show", "table_viz", "LivePlot"]


def table_viz(table: Table, sorting_col: str | None = None) -> Any:
    """Live table widget: ``rows`` tracks the table; renders as an HTML
    table (reference shows a Panel table widget)."""

    class LiveView:
        def __init__(self) -> None:
            self.rows: dict = {}

        def _repr_html_(self) -> str:
            cells = "".join(
                f"<tr>{''.join(f'<td>{_html.escape(str(v))}</td>' for v in row)}</tr>"
                for row in self.rows.values()
            )
            head = "".join(f"<th>{c}</th>" for c in table._column_names)
            return f"<table><tr>{head}</tr>{cells}</table>"

    view = LiveView()

    def on_change(key, row, time, is_addition):
        if is_addition:
            view.rows[key] = tuple(row.values())
        else:
            view.rows.pop(key, None)

    pw.io.subscribe(table, on_change=on_change, name="viz")
    return view


class LivePlot:
    """Continuously updated SVG chart over a table's numeric columns."""

    W, H, PAD = 640, 360, 45
    _COLORS = ["#3366cc", "#dc3912", "#109618", "#ff9900", "#990099"]

    def __init__(self, columns: list[str], x_col: str | None):
        self._columns = columns
        self._x_col = x_col
        self.rows: dict = {}

    # -- data ----------------------------------------------------------
    def _series(self) -> tuple[list, dict[str, list]]:
        rows = list(self.rows.values())
        cols = self._columns
        xi = cols.index(self._x_col) if self._x_col in cols else None
        if xi is not None:
            rows.sort(key=lambda r: (r[xi] is None, r[xi]))
            xs = [r[xi] for r in rows]
        else:
            xs = list(range(len(rows)))
        ys: dict[str, list] = {}
        for i, c in enumerate(cols):
            if i == xi:
                continue
            vals = [r[i] for r in rows]
            if all(isinstance(v, (int, float)) or v is None for v in vals) and any(
                isinstance(v, (int, float)) for v in vals
            ):
                ys[c] = vals
        return xs, ys

    # -- rendering -----------------------------------------------------
    def to_svg(self) -> str:
        xs, ys = self._series()
        W, H, P = self.W, self.H, self.PAD
        parts = [
            f'<svg xmlns="http://www.w3.org/2000/svg" width="{W}" height="{H}" '
            f'viewBox="0 0 {W} {H}" style="background:#fff;font-family:sans-serif">'
        ]
        parts.append(
            f'<rect x="{P}" y="{P}" width="{W - 2 * P}" height="{H - 2 * P}" '
            'fill="none" stroke="#999"/>'
        )
        numeric_x = [x for x in xs if isinstance(x, (int, float))]
        flat = [v for vs in ys.values() for v in vs if isinstance(v, (int, float))]
        if flat and (numeric_x or xs):
            if numeric_x:
                x0, x1 = min(numeric_x), max(numeric_x)
            else:
                x0, x1 = 0, max(len(xs) - 1, 1)
            y0, y1 = min(flat), max(flat)
            if x1 == x0:
                x1 = x0 + 1
            if y1 == y0:
                y1 = y0 + 1

            def px(x, i):
                v = x if isinstance(x, (int, float)) else i
                return P + (v - x0) / (x1 - x0) * (W - 2 * P)

            def py(y):
                return H - P - (y - y0) / (y1 - y0) * (H - 2 * P)

            for si, (name, vals) in enumerate(sorted(ys.items())):
                color = self._COLORS[si % len(self._COLORS)]
                pts = [
                    f"{px(x, i):.1f},{py(v):.1f}"
                    for i, (x, v) in enumerate(zip(xs, vals))
                    if isinstance(v, (int, float))
                ]
                if len(pts) > 1:
                    parts.append(
                        f'<polyline points="{" ".join(pts)}" fill="none" '
                        f'stroke="{color}" stroke-width="1.5"/>'
                    )
                for p in pts:
                    cx, cy = p.split(",")
                    parts.append(
                        f'<circle cx="{cx}" cy="{cy}" r="2.5" fill="{color}"/>'
                    )
                parts.append(
                    f'<text x="{W - P + 5}" y="{P + 14 * (si + 1)}" '
                    f'fill="{color}" font-size="12">{_html.escape(name)}</text>'
                )
            for frac, val in ((0.0, y0), (1.0, y1)):
                parts.append(
                    f'<text x="{P - 5}" y="{H - P - frac * (H - 2 * P) + 4}" '
                    f'text-anchor="end" font-size="11">{val:g}</text>'
                )
            for frac, val in ((0.0, x0), (1.0, x1)):
                label = f"{val:g}" if isinstance(val, (int, float)) else str(val)
                parts.append(
                    f'<text x="{P + frac * (W - 2 * P)}" y="{H - P + 16}" '
                    f'text-anchor="middle" font-size="11">{_html.escape(label)}</text>'
                )
        parts.append("</svg>")
        return "".join(parts)

    def _repr_html_(self) -> str:
        return self.to_svg()

    def save_html(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(
                "<!DOCTYPE html><html><body>" + self.to_svg() + "</body></html>"
            )


def plot(
    table: Table,
    plotting_function: Callable | None = None,
    sorting_col: str | None = None,
) -> Any:
    """Live plot of a table (reference ``stdlib/viz`` Bokeh integration).

    With Bokeh installed and a ``plotting_function(source) -> figure``,
    drives a live ``ColumnDataSource`` exactly like the reference;
    otherwise returns a :class:`LivePlot` SVG chart fed by the same
    subscription."""
    try:
        import bokeh.models  # noqa: F401

        have_bokeh = True
    except ImportError:
        have_bokeh = False
    if have_bokeh:
        # outside the probe try: an ImportError raised by the user's
        # plotting_function must propagate, not trigger the SVG fallback
        return _bokeh_plot(table, plotting_function, sorting_col)
    view = LivePlot(table._column_names, sorting_col)

    def on_change(key, row, time, is_addition):
        if is_addition:
            view.rows[key] = tuple(row.values())
        else:
            view.rows.pop(key, None)

    pw.io.subscribe(table, on_change=on_change, name="viz_plot")
    return view


def _bokeh_plot(
    table: Table, plotting_function: Callable | None, sorting_col: str | None
) -> Any:
    from bokeh.models import ColumnDataSource

    source = ColumnDataSource(data={c: [] for c in table._column_names})
    state: dict = {}

    def on_change(key, row, time, is_addition):
        if is_addition:
            state[key] = tuple(row.values())
        else:
            state.pop(key, None)

    def on_time_end(time):
        cols = table._column_names
        rows = list(state.values())
        if sorting_col in cols:
            si = cols.index(sorting_col)
            rows.sort(key=lambda r: (r[si] is None, r[si]))
        source.data = {c: [r[i] for r in rows] for i, c in enumerate(cols)}

    pw.io.subscribe(
        table, on_change=on_change, on_time_end=on_time_end, name="viz_plot"
    )
    if plotting_function is not None:
        return plotting_function(source)
    return source


show = table_viz
