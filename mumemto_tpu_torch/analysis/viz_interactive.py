"""Interactive synteny visualization: self-contained HTML (SVG + vanilla JS).

Counterpart of the reference's mumemto/viz_mums_interactive.py (plotly
go.Figure shapes -> html, :50-179). The interactive output is produced
without plotly or any other dependency:
the same polygon geometry as the static path (analysis/viz.py) is rendered
as inline SVG with wheel zoom (x-axis), drag pan, and per-polygon hover
highlighting. The result is one portable .html file.
"""

from __future__ import annotations

import html as _html
import os


def _fmt(x: float) -> str:
    return f"{x:.2f}".rstrip("0").rstrip(".")


def write_html(filename: str, seq_lengths, polygons, colors, centering,
               genome_names=None, alpha: float = 0.8,
               title: str = "mumemto synteny") -> str:
    """Render polygons (lists of (x, row) vertices) into an interactive
    standalone HTML file; returns the path written."""
    if os.path.splitext(filename)[1] != ".html":
        filename += ".html"
    n_rows = len(seq_lengths)
    max_len = max(seq_lengths) if seq_lengths else 1

    W, ROW_H, PAD = 1200.0, 48.0, 24.0
    H = ROW_H * max(n_rows - 1, 1) + 2 * PAD
    sx = W / max(max_len, 1)

    def X(x):
        return x * sx

    def Y(row):
        return PAD + row * ROW_H

    parts = []
    for idx, g in enumerate(seq_lengths):
        x0, x1 = X(centering[idx]), X(centering[idx] + g)
        parts.append(
            f'<line x1="{_fmt(x0)}" y1="{_fmt(Y(idx))}" x2="{_fmt(x1)}" '
            f'y2="{_fmt(Y(idx))}" stroke="#000" stroke-opacity="0.25" '
            'stroke-width="1" vector-effect="non-scaling-stroke"/>')
    for i, poly in enumerate(polygons):
        pts = " ".join(f"{_fmt(X(px))},{_fmt(Y(py))}" for px, py in poly)
        c = colors[i]
        parts.append(
            f'<polygon class="mum" points="{pts}" fill="{c}" '
            f'fill-opacity="{alpha}" stroke="{c}" stroke-width="0.5" '
            'vector-effect="non-scaling-stroke"/>')

    labels = []
    for idx in range(n_rows):
        name = (genome_names[idx] if genome_names and idx < len(genome_names)
                else f"seq {idx}")
        labels.append(
            f'<div class="lab" style="top:{_fmt(Y(idx) - 9)}px">'
            f'{_html.escape(str(name))}</div>')

    doc = f"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{_html.escape(title)}</title>
<style>
 body {{ font: 13px sans-serif; margin: 0; }}
 #wrap {{ position: relative; margin: 8px 8px 8px 140px; }}
 #labels {{ position: absolute; left: -136px; width: 128px; top: 0; }}
 .lab {{ position: absolute; right: 4px; white-space: nowrap;
         overflow: hidden; text-overflow: ellipsis; max-width: 128px; }}
 svg {{ border: 1px solid #ddd; display: block; width: 100%;
        height: {_fmt(H)}px; cursor: grab; }}
 .mum:hover {{ fill-opacity: 1; }}
 #hud {{ color: #666; margin: 4px 8px 8px 140px; }}
</style></head><body>
<h3 style="margin:8px 8px 0 140px">{_html.escape(title)}</h3>
<div id="wrap">
 <div id="labels">{''.join(labels)}</div>
 <svg id="sv" viewBox="0 0 {_fmt(W)} {_fmt(H)}" preserveAspectRatio="none">
  <g id="root">{''.join(parts)}</g>
 </svg>
</div>
<div id="hud">scroll = zoom x &middot; drag = pan &middot; double-click = reset
 &middot; position: <span id="pos">-</span> bp</div>
<script>
(function () {{
 var sv = document.getElementById('sv');
 var W = {_fmt(W)}, H = {_fmt(H)}, SX = {W / max(max_len, 1):.10g};
 var vx = 0, vw = W, drag = null;
 function apply() {{ sv.setAttribute('viewBox', vx + ' 0 ' + vw + ' ' + H); }}
 sv.addEventListener('wheel', function (e) {{
   e.preventDefault();
   var r = sv.getBoundingClientRect();
   var fx = vx + (e.clientX - r.left) / r.width * vw;
   var k = e.deltaY > 0 ? 1.2 : 1 / 1.2;
   vw = Math.min(W * 4, Math.max(W / 1e6, vw * k));
   vx = fx - (e.clientX - r.left) / r.width * vw;
   apply();
 }}, {{passive: false}});
 sv.addEventListener('mousedown', function (e) {{
   drag = {{x: e.clientX, vx: vx}}; sv.style.cursor = 'grabbing';
 }});
 window.addEventListener('mousemove', function (e) {{
   var r = sv.getBoundingClientRect();
   var bp = Math.round((vx + (e.clientX - r.left) / r.width * vw) / SX);
   var el = document.getElementById('pos');
   if (el) el.textContent = bp.toLocaleString();
   if (!drag) return;
   vx = drag.vx - (e.clientX - drag.x) / r.width * vw; apply();
 }});
 window.addEventListener('mouseup', function () {{
   drag = null; sv.style.cursor = 'grab';
 }});
 sv.addEventListener('dblclick', function () {{ vx = 0; vw = W; apply(); }});
}})();
</script></body></html>
"""
    with open(filename, "w") as f:
        f.write(doc)
    return filename
