"""Log plotting: grouped channels as figures or one HTML report.

Counterpart of ``jiminy_tpu/plot.py`` (numpy and text, the port's own
copy): channels are grouped by their dotted prefix (``q.0``, ``q.1`` →
``q``); :func:`plot_log` draws one matplotlib figure per group (imported
only there, the Agg backend when saving), :func:`export_html` writes a
self-contained report with an inline SVG sparkline per group.
"""

from __future__ import annotations

from collections import defaultdict
from pathlib import Path

import numpy as np

from jiminy_tpu_torch.telemetry import TelemetryLog


def group_columns(log: TelemetryLog) -> dict[str, list[str]]:
    """Group variable names by their dotted prefix: q.0, q.1 → tab "q"."""
    groups: dict[str, list[str]] = defaultdict(list)
    for name in log.columns:
        if name == "time":
            continue
        prefix = name.rsplit(".", 1)[0] if "." in name else name
        groups[prefix].append(name)
    return dict(groups)


def plot_log(
    log: TelemetryLog,
    tabs: list[str] | None = None,
    save_path: str | Path | None = None,
    max_lines_per_axis: int = 12,
):
    """One figure per group of channels; returns the list of figures.
    With ``save_path`` (a directory) figures are written to disk as PNG
    instead of shown, for headless hosts."""
    import matplotlib

    if save_path is not None:
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    t = np.asarray(log.time)
    groups = group_columns(log)
    if tabs is not None:
        groups = {k: v for k, v in groups.items() if k in tabs}
    figs = []
    for name, cols in groups.items():
        fig, ax = plt.subplots(figsize=(10, 4))
        for c in cols[:max_lines_per_axis]:
            ax.plot(t, np.asarray(log.columns[c]), label=c, linewidth=0.9)
        if len(cols) > max_lines_per_axis:
            ax.set_title(f"{name} (+{len(cols) - max_lines_per_axis} hidden)")
        else:
            ax.set_title(name)
        ax.set_xlabel("time [s]")
        ax.grid(True, alpha=0.3)
        ax.legend(fontsize=7, ncol=2)
        figs.append(fig)
        if save_path is not None:
            p = Path(save_path)
            p.mkdir(parents=True, exist_ok=True)
            fig.savefig(p / f"{name}.png", dpi=110, bbox_inches="tight")
            plt.close(fig)
    return figs


def export_html(log: TelemetryLog, path: str | Path, title="jiminy_tpu log"):
    """Self-contained HTML report (inline SVG sparkline per channel
    group), for headless hosts."""
    t = np.asarray(log.time)
    groups = group_columns(log)
    parts = [
        "<!DOCTYPE html><html><head><meta charset='utf-8'>",
        f"<title>{title}</title>",
        "<style>body{font-family:sans-serif;background:#fafafa;margin:2em}"
        ".card{background:#fff;border:1px solid #ddd;border-radius:8px;"
        "padding:1em;margin:1em 0}svg{width:100%;height:180px}"
        "path{fill:none;stroke-width:1.2}</style></head><body>",
        f"<h1>{title}</h1>",
        "<h3>Constants</h3><pre>"
        + "\n".join(f"{k} = {v}" for k, v in log.constants.items())
        + "</pre>",
    ]
    palette = ["#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
               "#8c564b", "#e377c2", "#7f7f7f", "#bcbd22", "#17becf"]
    t_lo, t_hi = float(t.min()), float(t.max()) or 1.0
    for name, cols in groups.items():
        paths = []
        vals = [np.asarray(log.columns[c], np.float64) for c in cols[:10]]
        v_lo = min(float(np.nanmin(v)) for v in vals)
        v_hi = max(float(np.nanmax(v)) for v in vals)
        span = (v_hi - v_lo) or 1.0
        for ci, v in enumerate(vals):
            # decimate to ≤600 points
            idx = np.linspace(0, len(t) - 1, min(600, len(t))).astype(int)
            xs = (t[idx] - t_lo) / max(t_hi - t_lo, 1e-9) * 1000.0
            ys = 170.0 - (v[idx] - v_lo) / span * 160.0
            d = "M" + " L".join(f"{x:.1f},{y:.1f}" for x, y in zip(xs, ys))
            paths.append(
                f"<path d='{d}' stroke='{palette[ci % len(palette)]}'/>"
            )
        legend = ", ".join(cols[:10])
        parts.append(
            f"<div class='card'><h3>{name}</h3>"
            f"<small>{legend} &nbsp; [{v_lo:.3g}, {v_hi:.3g}]</small>"
            f"<svg viewBox='0 0 1000 180'>{''.join(paths)}</svg></div>"
        )
    parts.append("</body></html>")
    Path(path).write_text("\n".join(parts))
