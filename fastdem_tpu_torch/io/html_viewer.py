"""Self-contained interactive 3D map viewer in one HTML file (port of
``fastdem_tpu/io/html_viewer.py``).

``save_html`` writes one dependency-free HTML file (no CDN, no SDK) that
embeds the elevation surface and a small software renderer: drag to
orbit, wheel to zoom. The page is the reference package's, byte for byte,
so both packages write the same file for the same map.

Encoding: the elevation layer downsampled to <= ``max_cells`` cells,
quantised to u16 over [zmin, zmax], base64 in the HTML. The layer is read
from its device once (``interop.host_state``).
"""

from __future__ import annotations

import base64
import json
from typing import Optional

import numpy as np

from fastdem_tpu_torch.grid.geometry import GridGeometry
from fastdem_tpu_torch.grid.gridmap import GridMapState, layers as L
from fastdem_tpu_torch.interop import host_state

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>fastdem_tpu map</title>
<style>
 body{margin:0;background:#10141a;color:#cfd8e3;font:12px monospace}
 #hud{position:fixed;top:8px;left:10px;white-space:pre}
 canvas{display:block}
</style></head><body>
<div id="hud"></div><canvas id="c"></canvas>
<script>
let META = {rows: 0, cols: 0, res: 1, zmin: 0, zmax: 1, title: "",
            z_exaggeration: 1.5};
let zq = new Float32Array(0);
let P = new Float32Array(0);   // last-scan points, xyz interleaved (m)
let mode = 0;                   // 0 surface, 1 points, 2 both
function decodeFrame(meta, b64, pb64){ // shared by static and live pages
  META = meta;
  const Z = Uint8Array.from(atob(b64), ch => ch.charCodeAt(0));
  zq = new Float32Array(META.rows * META.cols);
  for (let i = 0; i < zq.length; i++) {
    const q = Z[2 * i] | (Z[2 * i + 1] << 8);
    zq[i] = q === 65535 ? NaN :
      META.zmin + (q / 65534) * (META.zmax - META.zmin);
  }
  P = new Float32Array(0);
  if (pb64 && META.pts) { // u16 xyz triples quantized over pts.bounds
    const B = Uint8Array.from(atob(pb64), ch => ch.charCodeAt(0));
    const n = META.pts.n, lo = META.pts.lo, hi = META.pts.hi;
    P = new Float32Array(3 * n);
    for (let i = 0; i < 3 * n; i++) {
      const q = B[2 * i] | (B[2 * i + 1] << 8);
      const a = i % 3;
      P[i] = lo[a] + (q / 65535) * (hi[a] - lo[a]);
    }
  }
}
addEventListener("keydown", e => {
  if (e.key === "m") { mode = (mode + 1) % 3; draw(); }
});
__DATA_JS__
const cv = document.getElementById("c"), hud = document.getElementById("hud");
const ctx = cv.getContext("2d");
let yaw = 0.8, pitch = 0.9, zoom = 1.0, drag = null;
function resize(){cv.width = innerWidth; cv.height = innerHeight; draw();}
addEventListener("resize", resize);
cv.addEventListener("mousedown", e => drag = [e.clientX, e.clientY]);
addEventListener("mouseup", () => drag = null);
addEventListener("mousemove", e => {
  if (!drag) return;
  yaw += (e.clientX - drag[0]) * 0.008;
  pitch = Math.max(0.1, Math.min(1.5, pitch + (e.clientY - drag[1]) * 0.008));
  drag = [e.clientX, e.clientY]; draw();
});
cv.addEventListener("wheel", e => {
  zoom *= Math.exp(-e.deltaY * 0.001); draw(); e.preventDefault();
});
function colormap(t){ // viridis-ish
  const r = Math.max(0, Math.min(1, 1.5 * t - 0.25));
  const g = Math.max(0, Math.min(1, 1.4 * (1 - Math.abs(t - 0.6))));
  const b = Math.max(0, Math.min(1, 1.2 - 1.5 * t));
  return [68 + 187 * r, 30 + 200 * g, 90 + 120 * b];
}
function draw(){
  const {rows, cols, res, zmin, zmax} = META;
  ctx.fillStyle = "#10141a"; ctx.fillRect(0, 0, cv.width, cv.height);
  const cy = Math.cos(yaw), sy = Math.sin(yaw);
  const cp = Math.cos(pitch), sp = Math.sin(pitch);
  const ext = Math.max(rows, cols) * res;
  const s = zoom * Math.min(cv.width, cv.height) / (1.6 * ext);
  const zex = META.z_exaggeration;
  const cxs = cv.width / 2, cys = cv.height / 2;
  function proj(x, y, z){
    const u = -x * sy + y * cy;
    const v = -(x * cy + y * sy) * cp + (z - (zmin + zmax) / 2) * zex * sp;
    return [cxs + u * s, cys - v * s];
  }
  if (mode != 1) { // surface quads, painter-sorted back-to-front
    const order = [];
    for (let i = 0; i < rows - 1; i++)
      for (let j = 0; j < cols - 1; j++) {
        const z = zq[i * cols + j];
        if (isNaN(z)) continue;
        const x = (i - rows / 2) * res, y = (j - cols / 2) * res;
        const d = (x * cy + y * sy);
        order.push([d, i, j, z]);
      }
    order.sort((a, b) => a[0] - b[0]);
    for (const [d, i, j, z] of order) {
      const z10 = zq[(i + 1) * cols + j], z01 = zq[i * cols + j + 1];
      const x = (i - rows / 2) * res, y = (j - cols / 2) * res;
      const t = (z - zmin) / Math.max(1e-9, zmax - zmin);
      let [r, g, b] = colormap(t);
      // cheap slope shading from forward differences
      const gx = isNaN(z10) ? 0 : (z10 - z) / res;
      const gy = isNaN(z01) ? 0 : (z01 - z) / res;
      const shade = 1 / (1 + 0.8 * Math.hypot(gx, gy));
      ctx.fillStyle =
        `rgb(${r * shade | 0},${g * shade | 0},${b * shade | 0})`;
      const p0 = proj(x, y, z);
      const p1 = proj(x + res, y, isNaN(z10) ? z : z10);
      const p2 = proj(x + res, y + res, z);
      const p3 = proj(x, y + res, isNaN(z01) ? z : z01);
      ctx.beginPath();
      ctx.moveTo(p0[0], p0[1]); ctx.lineTo(p1[0], p1[1]);
      ctx.lineTo(p2[0], p2[1]); ctx.lineTo(p3[0], p3[1]);
      ctx.closePath(); ctx.fill();
    }
  }
  if (mode >= 1) { // map-as-cloud: one dot per valid cell center
    for (let i = 0; i < rows; i++)
      for (let j = 0; j < cols; j++) {
        const z = zq[i * cols + j];
        if (isNaN(z)) continue;
        const t = (z - zmin) / Math.max(1e-9, zmax - zmin);
        const [r, g, b] = colormap(t);
        ctx.fillStyle = `rgb(${r | 0},${g | 0},${b | 0})`;
        const p = proj((i - rows / 2) * res, (j - cols / 2) * res, z);
        ctx.fillRect(p[0] - 1, p[1] - 1, 2, 2);
      }
  }
  if (mode >= 1 && P.length) { // last-scan points (viewer frame)
    ctx.fillStyle = "#ff9d45";
    for (let i = 0; i < P.length; i += 3) {
      const p = proj(P[i], P[i + 1], P[i + 2]);
      ctx.fillRect(p[0] - 1, p[1] - 1, 2, 2);
    }
  }
  const modeName = ["surface", "points", "both"][mode];
  const nscan = P.length / 3;
  hud.textContent = `fastdem_tpu ${META.title}\\n` +
    `${rows}x${cols} cells @ ${res} m  z:[${zmin.toFixed(2)}, ` +
    `${zmax.toFixed(2)}] m` +
    (nscan ? `   scan: ${nscan} pts` : "") +
    `\\ndrag: orbit   wheel: zoom   m: view (${modeName})`;
}
resize();
</script></body></html>
"""


def encode_frame(
    geom: GridGeometry,
    state: GridMapState,
    layer: str = L.elevation,
    title: str = "elevation",
    max_cells: int = 160_000,
    z_exaggeration: float = 1.5,
):
    """Quantize one map layer into the viewer's wire frame.

    Returns ``(meta, payload)``: the JSON-able frame metadata and the
    little-endian u16 height grid (65535 = NaN). Shared by the static
    artifact (``save_html``) and the live stream (``live_viewer``)."""
    arr = np.asarray(host_state(state, [layer])[0][layer], dtype=np.float32)
    rows, cols = arr.shape
    stride = 1
    while (rows // stride) * (cols // stride) > max_cells:
        stride += 1
    arr = arr[::stride, ::stride]
    rows, cols = arr.shape
    finite = np.isfinite(arr)
    if finite.any():
        zmin = float(arr[finite].min())
        zmax = float(arr[finite].max())
    else:
        zmin, zmax = 0.0, 1.0
    if zmax <= zmin:
        zmax = zmin + 1e-3
    q = np.full(arr.shape, 65535, dtype=np.uint16)
    q[finite] = np.clip(
        np.round((arr[finite] - zmin) / (zmax - zmin) * 65534), 0, 65534
    ).astype(np.uint16)
    meta = {
        "rows": rows,
        "cols": cols,
        "res": geom.resolution * stride,
        "zmin": zmin,
        "zmax": zmax,
        "title": title,
        "z_exaggeration": z_exaggeration,
    }
    return meta, q.astype("<u2").tobytes()


def encode_points(
    pts: np.ndarray, max_points: int = 40_000
) -> tuple:
    """Quantize a point set into the viewer's wire format.

    ``pts`` are VIEWER-frame xyz (x = map-center-x minus world-x, etc.;
    see LiveViewer.publish). Returns (meta_pts, payload): per-axis bounds
    and the point count, and little-endian u16 xyz triples.
    """
    pts = np.asarray(pts, dtype=np.float32).reshape(-1, 3)
    if pts.shape[0] > max_points:
        stride = pts.shape[0] // max_points + 1
        pts = pts[::stride]
    if pts.shape[0] == 0:
        return {"n": 0, "lo": [0, 0, 0], "hi": [1, 1, 1]}, b""
    lo = pts.min(axis=0)
    hi = np.maximum(pts.max(axis=0), lo + 1e-6)
    q = np.clip(
        np.round((pts - lo) / (hi - lo) * 65535), 0, 65535
    ).astype("<u2")
    meta = {
        "n": int(pts.shape[0]),
        "lo": [float(v) for v in lo],
        "hi": [float(v) for v in hi],
    }
    return meta, q.tobytes()


def save_html(
    path: str,
    geom: GridGeometry,
    state: GridMapState,
    layer: str = L.elevation,
    title: str = "elevation",
    max_cells: int = 160_000,
    z_exaggeration: float = 1.5,
) -> bool:
    """Write a self-contained interactive 3D viewer for one map layer."""
    meta, payload = encode_frame(
        geom, state, layer, title, max_cells, z_exaggeration
    )
    data_js = 'decodeFrame({meta}, "{b64}");'.format(
        meta=json.dumps(meta),
        b64=base64.b64encode(payload).decode("ascii"),
    )
    page = _PAGE.replace("__DATA_JS__", data_js)
    try:
        with open(path, "w") as f:
            f.write(page)
    except OSError:
        return False
    return True
