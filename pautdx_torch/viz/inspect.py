"""Self-contained HTML inspectors: the human-in-the-loop QA surface.

The port's own copy of ``pautdx/viz/inspect.py``, host numpy and zlib
only, so the pages and PNG bytes are the reference's byte for byte. The
reference ships three PyQt6 apps for interactive inspection (B-scan
frames with annotation overlays, `display_defects.py`; signal sequences
with live predictions, `signal_visualizer.py`; a model tester,
`model_tester.py`). Here each is one static HTML file per dataset: all
frames or signals, annotations and predictions embedded, vanilla-JS
browsing (slider and arrow keys), GT/prediction overlay toggles, and
bad-sample flagging exported as JSON; it opens in any browser, without a
server.

PNG encoding is pure stdlib (zlib + struct) so the inspector works in
minimal images without matplotlib/PIL.
"""

from __future__ import annotations

import base64
import html
import json
import struct
import zlib
from typing import Dict, List

import numpy as np


# ---------------------------------------------------------------------------
# minimal PNG writer (stdlib only)


def png_bytes(img: np.ndarray) -> bytes:
    """Encode (H, W) or (H, W, 3) uint8 (or float in [0, 1]) as PNG."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if arr.ndim == 2:
        color_type, channels = 0, 1
    elif arr.ndim == 3 and arr.shape[2] == 3:
        color_type, channels = 2, 3
    else:
        raise ValueError(f"unsupported image shape {arr.shape}")
    h, w = arr.shape[:2]
    raw = arr.reshape(h, w * channels)
    # filter type 0 (None) per scanline
    scanlines = b"".join(b"\x00" + raw[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(scanlines, 6))
            + chunk(b"IEND", b""))


def png_data_uri(img: np.ndarray) -> str:
    return ("data:image/png;base64,"
            + base64.b64encode(png_bytes(img)).decode("ascii"))


# ---------------------------------------------------------------------------
# B-scan frame inspector (display_defects.py / model_tester.py analogue)

_BSCAN_JS = r"""
const D = JSON.parse(document.getElementById('data').textContent);
let si = 0, fi = 0, showGT = true, showPred = true;
const flagged = new Set();
const seqSel = document.getElementById('seq');
D.sequences.forEach((s, i) => {
  const o = document.createElement('option');
  o.value = i; o.textContent = s.name + ' (' + s.frames.length + ' frames)';
  seqSel.appendChild(o);
});
const slider = document.getElementById('frame');
const canvas = document.getElementById('view');
const ctx = canvas.getContext('2d');
const img = new Image();
img.onload = draw;
function colors(i) {
  const pal = ['#00e676','#40c4ff','#ffd740','#ff6e40','#ea80fc','#b2ff59'];
  return pal[i % pal.length];
}
function load() {
  const s = D.sequences[si];
  slider.max = s.frames.length - 1;
  slider.value = fi;
  img.src = s.frames[fi].png;
  document.getElementById('label').textContent =
    s.name + '  frame ' + fi + '/' + (s.frames.length - 1);
  document.getElementById('flag').textContent =
    flagged.has(si + ':' + fi) ? 'unflag (b)' : 'flag bad (b)';
}
function drawBoxes(boxes, stroke, dash, withScore) {
  ctx.setLineDash(dash); ctx.lineWidth = 2; ctx.font = '13px monospace';
  for (const b of boxes) {
    const [x1, y1, x2, y2] = b.box;
    ctx.strokeStyle = stroke || colors(b.label_id || 0);
    ctx.strokeRect(x1, y1, x2 - x1, y2 - y1);
    ctx.fillStyle = ctx.strokeStyle;
    let t = String(b.label);
    if (withScore && b.score !== undefined) t += ' ' + b.score.toFixed(2);
    ctx.fillText(t, x1 + 2, Math.max(12, y1 - 3));
  }
}
function draw() {
  const s = D.sequences[si];
  canvas.width = img.width; canvas.height = img.height;
  ctx.drawImage(img, 0, 0);
  const f = s.frames[fi];
  if (showGT && f.gt) drawBoxes(f.gt, '#00e676', [], false);
  if (showPred && f.pred) drawBoxes(f.pred, '#ff5252', [6, 3], true);
  if (flagged.has(si + ':' + fi)) {
    ctx.strokeStyle = '#ff1744'; ctx.lineWidth = 6; ctx.setLineDash([]);
    ctx.strokeRect(0, 0, canvas.width, canvas.height);
  }
  const n = D.sequences.reduce((a, s) => a + s.frames.length, 0);
  document.getElementById('stats').textContent =
    D.sequences.length + ' sequences, ' + n + ' frames; flagged: ' + flagged.size;
}
function setFrame(i) {
  const s = D.sequences[si];
  fi = Math.max(0, Math.min(s.frames.length - 1, i));
  load();
}
seqSel.onchange = () => { si = +seqSel.value; fi = 0; load(); };
slider.oninput = () => setFrame(+slider.value);
document.getElementById('gt').onchange = e => { showGT = e.target.checked; draw(); };
document.getElementById('pred').onchange = e => { showPred = e.target.checked; draw(); };
function toggleFlag() {
  const k = si + ':' + fi;
  flagged.has(k) ? flagged.delete(k) : flagged.add(k);
  load(); draw();
}
document.getElementById('flag').onclick = toggleFlag;
document.getElementById('export').onclick = () => {
  const out = [...flagged].map(k => {
    const [a, b] = k.split(':');
    return {sequence: D.sequences[+a].name, frame: +b};
  });
  const blob = new Blob([JSON.stringify(out, null, 1)], {type: 'application/json'});
  const a = document.createElement('a');
  a.href = URL.createObjectURL(blob); a.download = 'flagged_frames.json';
  a.click();
};
document.addEventListener('keydown', e => {
  if (e.key === 'ArrowRight') setFrame(fi + 1);
  else if (e.key === 'ArrowLeft') setFrame(fi - 1);
  else if (e.key === 'ArrowDown') { si = (si + 1) % D.sequences.length; fi = 0; seqSel.value = si; load(); }
  else if (e.key === 'ArrowUp') { si = (si - 1 + D.sequences.length) % D.sequences.length; fi = 0; seqSel.value = si; load(); }
  else if (e.key === 'b') toggleFlag();
  else if (e.key === 'g') { showGT = !showGT; document.getElementById('gt').checked = showGT; draw(); }
  else if (e.key === 'p') { showPred = !showPred; document.getElementById('pred').checked = showPred; draw(); }
});
load();
"""

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
body {{ background:#14181d; color:#d7dde3; font:14px system-ui, sans-serif;
       margin:0; padding:16px; }}
h1 {{ font-size:17px; margin:0 0 10px; }}
.bar {{ display:flex; gap:14px; align-items:center; flex-wrap:wrap;
        margin-bottom:10px; }}
select, button {{ background:#222a33; color:#d7dde3;
        border:1px solid #39434e; border-radius:4px; padding:4px 9px; }}
button:hover {{ background:#2d3844; cursor:pointer; }}
canvas, svg {{ background:#000; border:1px solid #39434e; max-width:100%; }}
input[type=range] {{ width:360px; }}
.hint {{ color:#7b8794; font-size:12px; }}
#stats {{ color:#7b8794; font-size:12px; margin-top:8px; }}
.legend span {{ padding:0 8px; }}
</style></head><body>
<h1>{title}</h1>
<div class="bar">{controls}</div>
{body}
<div id="stats"></div>
<div class="hint">{hint}</div>
<script type="application/json" id="data">{data}</script>
<script>{js}</script>
</body></html>
"""


def build_bscan_inspector(sequences: List[Dict], out_path: str,
                          title: str = "pautdx B-scan inspector") -> str:
    """Write a self-contained B-scan browse/overlay HTML page.

    sequences: list of ``{"name", "images" (T,H,W[,3]) float[0,1]|uint8,
    "gt": [per-frame [{box,label}]], "pred": [per-frame
    [{box,label,score}]]}`` — gt/pred optional. Returns out_path.
    """
    payload = {"sequences": []}
    for seq in sequences:
        images = np.asarray(seq["images"])
        frames = []
        for t in range(images.shape[0]):
            frames.append({
                "png": png_data_uri(images[t]),
                "gt": (seq.get("gt") or [None] * images.shape[0])[t],
                "pred": (seq.get("pred") or [None] * images.shape[0])[t],
            })
        payload["sequences"].append({"name": seq["name"], "frames": frames})
    controls = (
        '<select id="seq"></select>'
        '<input type="range" id="frame" min="0" value="0">'
        '<span id="label"></span>'
        '<label><input type="checkbox" id="gt" checked> GT</label>'
        '<label><input type="checkbox" id="pred" checked> predictions</label>'
        '<button id="flag">flag bad (b)</button>'
        '<button id="export">export flagged</button>'
        '<span class="legend"><span style="color:#00e676">GT</span>'
        '<span style="color:#ff5252">pred</span></span>')
    doc = _PAGE.format(
        title=html.escape(title), controls=controls,
        body='<canvas id="view"></canvas>',
        hint="&larr;/&rarr; frame &middot; &uarr;/&darr; sequence &middot; "
             "b flag &middot; g/p toggle overlays",
        data=json.dumps(payload), js=_BSCAN_JS)
    with open(out_path, "w") as f:
        f.write(doc)
    return out_path


# ---------------------------------------------------------------------------
# signal-sequence inspector (signal_visualizer.py / model_tester.py analogue)

_SIGNAL_JS = r"""
const D = JSON.parse(document.getElementById('data').textContent);
let si = 0, ni = 0;
const seqSel = document.getElementById('seq');
D.sequences.forEach((s, i) => {
  const o = document.createElement('option');
  o.value = i; o.textContent = s.name + ' (' + s.signals.length + ' signals)';
  seqSel.appendChild(o);
});
const slider = document.getElementById('sig');
const svg = document.getElementById('plot');
const strip = document.getElementById('strip');
const W = 900, H = 320, PAD = 28;
function seq() { return D.sequences[si]; }
function band(x1, x2, color, op) {
  return '<rect x="' + x1 + '" y="0" width="' + Math.max(1, x2 - x1) +
    '" height="' + H + '" fill="' + color + '" opacity="' + op + '"/>';
}
function draw() {
  const s = seq();
  const y = s.signals[ni];
  const n = y.length;
  let lo = Math.min(...y), hi = Math.max(...y);
  if (hi - lo < 1e-9) hi = lo + 1;
  const X = i => PAD + i * (W - 2 * PAD) / (n - 1);
  const Y = v => H - PAD - (v - lo) * (H - 2 * PAD) / (hi - lo);
  let el = '';
  const gp = s.positions && s.positions[ni];
  if (gp && s.labels[ni] > 0)
    el += band(X(gp[0] * (n - 1)), X(gp[1] * (n - 1)), '#00e676', 0.18);
  const pp = s.pred_positions && s.pred_positions[ni];
  const prob = s.probs ? s.probs[ni] : null;
  if (pp && prob !== null && prob >= 0.5)
    el += band(X(pp[0] * (n - 1)), X(pp[1] * (n - 1)), '#ff5252', 0.18);
  el += '<path fill="none" stroke="#40c4ff" stroke-width="1.4" d="M' +
    y.map((v, i) => X(i).toFixed(1) + ',' + Y(v).toFixed(1)).join('L') + '"/>';
  el += '<text x="' + PAD + '" y="16" fill="#d7dde3" font-size="13">' +
    s.name + ' &middot; signal ' + ni + '/' + (s.signals.length - 1) +
    ' &middot; GT ' + (s.labels[ni] > 0 ? (s.label_names ? s.label_names[ni] : 'defect') : 'health') +
    (prob !== null ? ' &middot; p(defect)=' + prob.toFixed(3) : '') + '</text>';
  svg.innerHTML = el;
  // probability/GT strip: one cell per signal
  const m = s.signals.length, cw = W / m;
  let cells = '';
  for (let i = 0; i < m; i++) {
    const p = s.probs ? s.probs[i] : 0;
    const r = Math.round(255 * p), g = Math.round(80 * (1 - p));
    cells += '<rect x="' + (i * cw) + '" y="0" width="' + Math.ceil(cw) +
      '" height="22" fill="rgb(' + r + ',' + g + ',60)"/>';
    if (s.labels[i] > 0)
      cells += '<rect x="' + (i * cw) + '" y="24" width="' + Math.ceil(cw) +
        '" height="6" fill="#00e676"/>';
    if (i === ni)
      cells += '<rect x="' + (i * cw) + '" y="0" width="' + Math.ceil(cw) +
        '" height="30" fill="none" stroke="#fff"/>';
  }
  strip.innerHTML = cells;
  document.getElementById('stats').textContent =
    'strip: top = p(defect) per signal (dark→red), green = GT defect';
}
function setSig(i) {
  ni = Math.max(0, Math.min(seq().signals.length - 1, i));
  slider.max = seq().signals.length - 1; slider.value = ni; draw();
}
seqSel.onchange = () => { si = +seqSel.value; setSig(0); };
slider.oninput = () => setSig(+slider.value);
strip.onclick = e => {
  const r = strip.getBoundingClientRect();
  setSig(Math.floor((e.clientX - r.left) / r.width * seq().signals.length));
};
document.addEventListener('keydown', e => {
  if (e.key === 'ArrowRight') setSig(ni + 1);
  else if (e.key === 'ArrowLeft') setSig(ni - 1);
  else if (e.key === 'ArrowDown') { si = (si + 1) % D.sequences.length; seqSel.value = si; setSig(0); }
  else if (e.key === 'ArrowUp') { si = (si - 1 + D.sequences.length) % D.sequences.length; seqSel.value = si; setSig(0); }
});
setSig(0);
"""


def build_signal_inspector(sequences: List[Dict], out_path: str,
                           title: str = "pautdx signal inspector") -> str:
    """Write a self-contained signal browse HTML page.

    sequences: list of ``{"name", "signals" (N,S), "labels" (N,),
    "positions" (N,2) normalized | None, "probs" (N,) | None,
    "pred_positions" (N,2) | None, "label_names" [str] | None}``.
    Returns out_path.
    """
    payload = {"sequences": []}
    for seq in sequences:
        sig = np.asarray(seq["signals"], np.float32)
        entry = {
            "name": seq["name"],
            "signals": np.round(sig, 5).tolist(),
            "labels": np.asarray(seq["labels"]).astype(int).tolist(),
            "positions": (np.asarray(seq["positions"]).tolist()
                          if seq.get("positions") is not None else None),
            "probs": (np.round(np.asarray(seq["probs"], np.float64), 5).tolist()
                      if seq.get("probs") is not None else None),
            "pred_positions": (np.asarray(seq["pred_positions"]).tolist()
                               if seq.get("pred_positions") is not None
                               else None),
            "label_names": seq.get("label_names"),
        }
        payload["sequences"].append(entry)
    controls = ('<select id="seq"></select>'
                '<input type="range" id="sig" min="0" value="0">'
                '<span class="legend"><span style="color:#00e676">GT span'
                '</span><span style="color:#ff5252">pred span</span></span>')
    body = ('<svg id="plot" width="900" height="320"></svg><br>'
            '<svg id="strip" width="900" height="30" '
            'style="margin-top:6px;cursor:pointer"></svg>')
    doc = _PAGE.format(
        title=html.escape(title), controls=controls, body=body,
        hint="&larr;/&rarr; signal &middot; &uarr;/&darr; sequence &middot; "
             "click the strip to jump",
        data=json.dumps(payload), js=_SIGNAL_JS)
    with open(out_path, "w") as f:
        f.write(doc)
    return out_path
