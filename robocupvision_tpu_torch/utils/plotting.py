"""Training-curve logging — the Visdom LinePlotter's replacement (a copy
of the JAX package's utils/plotting.py, which imports no JAX).

The reference streams loss curves to a Visdom server (visualize.py:4-21,
port 8097). Here ``LinePlotter`` keeps the same ``plot(var, split, x, y)``
call surface and offers three sinks:

- TSV files (always) and PNG charts via ``render()`` (when matplotlib is
  available) — artifacts live next to the checkpoints;
- ``serve(port=8097)`` — a dependency-free live view: a background
  http.server renders the in-memory series as auto-refreshing inline-SVG
  charts, the functional equivalent of the reference's Visdom dashboard.
"""

from __future__ import annotations

import os
import threading
from collections import defaultdict
from typing import Dict, List, Tuple


class LinePlotter:
    def __init__(self, env_name: str = "main", out_dir: str = "plots"):
        self.env = env_name
        self.out_dir = out_dir
        self.series: Dict[str, Dict[str, List[Tuple[float, float]]]] = \
            defaultdict(lambda: defaultdict(list))
        # serve() handler threads read series while the trainer appends
        self._lock = threading.Lock()
        os.makedirs(out_dir, exist_ok=True)

    def plot(self, var_name: str, split_name: str, x: float, y: float) -> None:
        with self._lock:
            self.series[var_name][split_name].append((float(x), float(y)))
        path = os.path.join(self.out_dir, f"{self.env}_{var_name}.tsv")
        write_header = not os.path.exists(path)
        with open(path, "a") as f:
            if write_header:
                f.write("split\tx\ty\n")
            f.write(f"{split_name}\t{x}\t{y}\n")

    # -- live view (Visdom analog) -------------------------------------------

    _COLORS = ["#1f77b4", "#d62728", "#2ca02c", "#9467bd", "#ff7f0e"]

    def _snapshot(self) -> Dict[str, Dict[str, List[Tuple[float, float]]]]:
        with self._lock:
            return {v: {s: list(pts) for s, pts in sp.items()}
                    for v, sp in self.series.items()}

    def _svg(self, var: str, splits, w: int = 640, h: int = 320) -> str:
        parts = [f'<h3>{var}</h3><svg width="{w}" height="{h}" '
                 f'style="background:#fafafa;border:1px solid #ddd">']
        pts_all = [p for pts in splits.values() for p in pts]
        if pts_all:
            xs = [p[0] for p in pts_all]
            ys = [p[1] for p in pts_all]
            x0, x1 = min(xs), max(xs)
            y0, y1 = min(ys), max(ys)
            sx = (w - 60) / max(x1 - x0, 1e-12)
            sy = (h - 40) / max(y1 - y0, 1e-12)
            for ci, (split, pts) in enumerate(sorted(splits.items())):
                col = self._COLORS[ci % len(self._COLORS)]
                poly = " ".join(
                    f"{40 + (x - x0) * sx:.1f},{h - 20 - (y - y0) * sy:.1f}"
                    for x, y in pts)
                parts.append(f'<polyline points="{poly}" fill="none" '
                             f'stroke="{col}" stroke-width="1.5"/>')
                parts.append(f'<text x="{w - 120}" y="{20 + 16 * ci}" '
                             f'fill="{col}">{split}</text>')
            parts.append(f'<text x="4" y="{h - 24}" font-size="10">'
                         f'{y0:.4g}</text>')
            parts.append(f'<text x="4" y="14" font-size="10">{y1:.4g}</text>')
        parts.append("</svg>")
        return "".join(parts)

    def _page(self) -> str:
        series = self._snapshot()
        charts = "".join(self._svg(v, series[v]) for v in sorted(series))
        return ("<html><head><meta http-equiv='refresh' content='2'>"
                f"<title>{self.env}</title></head><body>"
                f"<h2>robocupvision_tpu — {self.env}</h2>"
                f"{charts or '<p>no data yet</p>'}</body></html>")

    def serve(self, port: int = 8097):
        """Start the live dashboard (reference visualize.py uses Visdom on
        port 8097). Returns the http.server instance; call ``.shutdown()``
        to stop. ``port=0`` picks an ephemeral port (``server_address[1]``).
        """
        import http.server

        plotter = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                body = plotter._page().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # silence request logging
                pass

        srv = http.server.ThreadingHTTPServer(("127.0.0.1", port), Handler)
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        return srv

    def render(self) -> List[str]:
        """Write one PNG per variable; returns the file paths."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:  # pragma: no cover
            return []
        out = []
        for var, splits in self._snapshot().items():
            fig, ax = plt.subplots(figsize=(6, 4))
            for split, pts in splits.items():
                xs, ys = zip(*pts)
                ax.plot(xs, ys, label=split)
            ax.set_title(var)
            ax.set_xlabel("Iters")
            ax.set_ylabel(var)
            ax.legend()
            path = os.path.join(self.out_dir, f"{self.env}_{var}.png")
            fig.savefig(path, dpi=100, bbox_inches="tight")
            plt.close(fig)
            out.append(path)
        return out
