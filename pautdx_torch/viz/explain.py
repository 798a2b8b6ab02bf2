"""Animated HTML explainers of the PAUT pipeline.

The port's own copy of ``pautdx/viz/explain.py``, host numpy only: the
same scenes over the port's ``data/synthetic.py`` and
``utils/autogates.py``, which draw the reference's numpy values, so each
page is the reference's byte for byte. The reference ships a suite of
manim scenes rendering MP4 explainer videos of the PAUT pipeline
(`signals/improved_multisignal/visualization/README.md`); here each is a
self-contained animated HTML page: vanilla-JS canvas animation with a
play/scrub timeline, data embedded inline, opened in any browser without
a server. Each scene animates data from the generators the models train
on, not hand-drawn props.

Scenes:

- ``build_paut_structure``   — the (beams, scans, samples) volume as an
  isometric sweep: the scan plane moves through the volume revealing the
  D-scan (per-cell peak amplitude) with defect extents outlined, while a
  side panel draws the live B-scan slice. (`paut_3d_visualization.py`)
- ``build_signal_sequence`` — a 50-scan window sliding over one beam's
  B-scan, with the center A-scan traced live and the defect echo
  annotated: how SequenceDataset windows are cut.
  (`signal_sequence_video.py`)
- ``build_autogates``       — the gate-finding algorithm step by step:
  row statistics, the derived threshold, and the detected interface/
  backwall gates sweeping in. (`autogates_visualization.py`, ported
  algorithm: `pautdx_torch.utils.autogates.find_gates`)
- ``build_iou``             — a predicted box sliding across a GT box
  with live intersection shading and the IoU value/threshold readout.
  (`iou_visualization.py`)
- ``build_pipeline``        — staged reveal of the signal pipeline
  (volume -> windows -> conv encoder -> transformer -> per-signal
  probabilities) with real layer shapes. (`detailed_neural_pipeline.py`)

``build_explainers(out_dir)`` writes all five and an index page.
"""

from __future__ import annotations

import base64
import json
import os
from typing import List

import numpy as np

from pautdx_torch.data import synthetic
from pautdx_torch.utils.autogates import find_gates, row_statistics

_CSS = """
body { font-family: system-ui, sans-serif; background: #11161d;
       color: #dfe7f1; margin: 0; padding: 16px; }
h1 { font-size: 18px; margin: 0 0 4px; }
p.sub { color: #8fa3b8; margin: 0 0 12px; font-size: 13px; max-width: 72em; }
canvas { background: #0a0e13; border: 1px solid #273244;
         border-radius: 6px; display: block; }
.row { display: flex; gap: 16px; align-items: flex-start; flex-wrap: wrap; }
.controls { margin: 10px 0; display: flex; gap: 10px; align-items: center; }
button, input[type=range] { accent-color: #4da3ff; }
button { background: #1d2633; border: 1px solid #33415a; color: #dfe7f1;
         border-radius: 5px; padding: 4px 14px; cursor: pointer; }
.legend { font-size: 12px; color: #8fa3b8; }
a { color: #4da3ff; }
"""


def _page(title: str, subtitle: str, body: str, data: dict,
          scene_js: str) -> str:
    return f"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>{_CSS}</style></head>
<body>
<h1>{title}</h1>
<p class="sub">{subtitle}</p>
{body}
<div class="controls">
  <button id="play">&#9654; play</button>
  <input type="range" id="scrub" min="0" max="1000" value="0" style="width:360px">
  <span class="legend" id="tlabel"></span>
</div>
<script>
const DATA = {json.dumps(data)};
function u8(b64) {{
  const s = atob(b64); const a = new Uint8Array(s.length);
  for (let i = 0; i < s.length; i++) a[i] = s.charCodeAt(i);
  return a;
}}
let t = 0, playing = false, last = null;
const scrub = document.getElementById('scrub');
const playBtn = document.getElementById('play');
playBtn.onclick = () => {{ playing = !playing;
  playBtn.innerHTML = playing ? '&#10074;&#10074; pause' : '&#9654; play'; }};
scrub.oninput = () => {{ t = scrub.value / 1000; draw(t); }};
function tick(ts) {{
  if (playing) {{
    if (last !== null) t = (t + (ts - last) / {data.get("duration_ms", 9000)}) % 1;
    scrub.value = Math.round(t * 1000);
    draw(t);
  }}
  last = ts;
  requestAnimationFrame(tick);
}}
{scene_js}
draw(0);
requestAnimationFrame(tick);
</script>
</body></html>"""


def _b64(arr: np.ndarray) -> str:
    a = np.asarray(arr)
    if a.dtype != np.uint8:
        a = (np.clip(a, 0.0, 1.0) * 255 + 0.5).astype(np.uint8)
    return base64.b64encode(a.tobytes()).decode("ascii")


def _demo_volume(seed: int = 7):
    spec = synthetic.VolumeSpec(n_beams=6, n_scans=48, n_samples=160,
                                noise=0.05, seed=seed)
    defects = [synthetic.SyntheticDefect(1, 3, 10, 22, 0.35, 0.5),
               synthetic.SyntheticDefect(3, 5, 30, 40, 0.6, 0.72,
                                         amplitude=0.7)]
    vol, defects = synthetic.generate_volume(spec, defects)
    return spec, defects, vol


def build_paut_structure(out_path: str, seed: int = 7) -> str:
    spec, defects, vol = _demo_volume(seed)
    # D-scan: per-(beam, scan) peak amplitude inside the inspection gate
    lo = int(spec.frontwall_pos * spec.n_samples) + 6
    hi = int(spec.backwall_pos * spec.n_samples) - 4
    dscan = np.abs(vol[:, :, lo:hi]).max(-1)
    dscan = dscan / max(dscan.max(), 1e-6)
    data = {
        "B": spec.n_beams, "S": spec.n_scans, "N": spec.n_samples,
        "duration_ms": 9000,
        "dscan": _b64(dscan),
        "vol": _b64(np.abs(vol)),
        "defects": [[d.beam_start, d.beam_end, d.scan_start, d.scan_end]
                    for d in defects],
    }
    body = ('<div class="row"><canvas id="iso" width="640" height="420">'
            '</canvas><canvas id="slice" width="360" height="420"></canvas>'
            '</div><div class="legend">left: isometric (beam &times; scan) '
            'D-scan revealed by the sweeping scan plane; red outlines = '
            'ground-truth defect extents. right: the live B-scan slice '
            '(beams &times; depth) at the sweep position.</div>')
    js = """
const dscan = u8(DATA.dscan), vol = u8(DATA.vol);
const iso = document.getElementById('iso').getContext('2d');
const sl = document.getElementById('slice').getContext('2d');
function cell(b, s) { // isometric projection of (beam, scan) cell
  const x = 60 + s * 9 + b * 28, y = 330 - s * 4.5 + b * 6;
  return [x, y];
}
function heat(v) {
  const r = Math.round(30 + 225 * v), g = Math.round(40 + 140 * v);
  return `rgb(${r},${g},${Math.round(70 + 60 * (1 - v))})`;
}
function draw(t) {
  const B = DATA.B, S = DATA.S, N = DATA.N;
  const sweep = Math.min(S - 1, Math.floor(t * S));
  iso.clearRect(0, 0, 640, 420);
  for (let b = B - 1; b >= 0; b--) for (let s = 0; s < S; s++) {
    const [x, y] = cell(b, s);
    const v = s <= sweep ? dscan[b * S + s] / 255 : 0.04;
    iso.fillStyle = heat(v);
    iso.fillRect(x, y, 8, 12);
  }
  iso.strokeStyle = '#ff5566'; iso.lineWidth = 2;
  for (const [b0, b1, s0, s1] of DATA.defects) {
    if (s0 > sweep) continue;
    const [xa, ya] = cell(b1, s0), [xb, yb] = cell(b0, Math.min(s1, sweep));
    iso.strokeRect(Math.min(xa, xb) - 1, Math.min(ya, yb) - 1,
                   Math.abs(xb - xa) + 10, Math.abs(yb - ya) + 15);
  }
  // sweep-plane marker along the beam axis at the current scan
  iso.strokeStyle = '#4da3ff'; iso.lineWidth = 2; iso.beginPath();
  const [ax, ay] = cell(0, sweep), [bx, by] = cell(B - 1, sweep);
  iso.moveTo(ax + 4, ay - 6); iso.lineTo(bx + 4, by - 6);
  iso.stroke();
  document.getElementById('tlabel').textContent =
    `scan ${sweep + 1} / ${S}`;
  // B-scan slice at the sweep scan: beams x samples
  sl.clearRect(0, 0, 360, 420);
  const cw = 360 / DATA.B, ch = 400 / N;
  for (let b = 0; b < DATA.B; b++) for (let n = 0; n < N; n++) {
    const v = vol[(b * S + sweep) * N + n] / 255;
    sl.fillStyle = heat(v);
    sl.fillRect(b * cw, 10 + n * ch, cw - 1, Math.max(1, ch));
  }
}
"""
    html_text = _page(
        "PAUT data structure — (beams × scans × samples)",
        "How a phased-array ultrasound volume is organized: each scan "
        "position yields one B-scan slice (beams × depth samples); the "
        "stack of slices forms the volume the detectors train on. "
        "Reference scene: visualization/paut_3d_visualization.py "
        "(manim), re-rendered as live HTML from the same kind of "
        "generated volume (pautdx.data.synthetic).",
        body, data, js)
    with open(out_path, "w") as f:
        f.write(html_text)
    return out_path


def build_signal_sequence(out_path: str, seed: int = 7,
                          seq_len: int = 24) -> str:
    spec, defects, vol = _demo_volume(seed)
    beam = 2
    bscan = np.abs(vol[beam])                        # (S, N)
    bscan = bscan / max(bscan.max(), 1e-6)
    labels = np.zeros(spec.n_scans, np.uint8)
    for d in defects:
        if d.beam_start <= beam <= d.beam_end:
            labels[d.scan_start:d.scan_end + 1] = 1
    data = {"S": spec.n_scans, "N": spec.n_samples, "L": seq_len,
            "duration_ms": 9000,
            "bscan": _b64(bscan), "labels": _b64(labels),
            "trace": [float(v) for v in vol[beam, :, :].mean(0)]}
    body = ('<div class="row"><canvas id="bs" width="620" height="300">'
            '</canvas><canvas id="asc" width="380" height="300"></canvas>'
            '</div><div class="legend">left: one beam\'s B-scan (scans '
            '&times; depth) with the sliding sequence window (blue) the '
            'dataset cuts; orange scans carry a defect. right: the '
            'window-center A-scan, echo amplitude over depth.</div>')
    js = """
const bs = document.getElementById('bs').getContext('2d');
const asc = document.getElementById('asc').getContext('2d');
const img = u8(DATA.bscan), lab = u8(DATA.labels);
function draw(t) {
  const S = DATA.S, N = DATA.N, L = DATA.L;
  const start = Math.min(S - L, Math.floor(t * (S - L + 1)));
  bs.clearRect(0, 0, 620, 300);
  const cw = 600 / S, ch = 280 / N;
  for (let s = 0; s < S; s++) for (let n = 0; n < N; n++) {
    const v = img[s * N + n] / 255;
    bs.fillStyle = `rgb(${30 + 200 * v},${40 + 150 * v},90)`;
    bs.fillRect(10 + s * cw, 10 + n * ch, cw, Math.max(1, ch));
  }
  for (let s = 0; s < S; s++) if (lab[s]) {
    bs.fillStyle = 'rgba(255,160,40,0.9)';
    bs.fillRect(10 + s * cw, 2, cw, 5);
  }
  bs.strokeStyle = '#4da3ff'; bs.lineWidth = 2;
  bs.strokeRect(10 + start * cw, 8, L * cw, 284);
  const center = start + Math.floor(L / 2);
  document.getElementById('tlabel').textContent =
    `window [${start}, ${start + L}) of ${S} scans — center scan ` +
    `${center}${lab[center] ? ' (DEFECT)' : ''}`;
  asc.clearRect(0, 0, 380, 300);
  asc.strokeStyle = lab[center] ? '#ffa028' : '#6fd18a';
  asc.beginPath();
  for (let n = 0; n < N; n++) {
    const v = img[center * N + n] / 255;
    const x = 10 + 360 * n / N, y = 280 - 260 * v;
    if (n === 0) asc.moveTo(x, y); else asc.lineTo(x, y);
  }
  asc.stroke();
}
"""
    html_text = _page(
        "Signal-sequence extraction — how training windows are cut",
        "SequenceDataset slides a fixed-length window of consecutive "
        "scans along each beam; the per-scan A-scans in the window form "
        "one training sequence, labeled per signal. Reference scene: "
        "visualization/signal_sequence_video.py (manim).",
        body, data, js)
    with open(out_path, "w") as f:
        f.write(html_text)
    return out_path


def build_autogates(out_path: str, seed: int = 7) -> str:
    spec, defects, vol = _demo_volume(seed)
    # autogates consume a (scans, samples) image of one beam: sample
    # positions with persistently high energy are wall echoes
    beam = 2
    bscan = np.abs(vol[beam])                        # (scans, samples)
    stats = row_statistics(bscan)                    # per-sample mean |amp|
    # the algorithm gates between |second-derivative| peaks >= max/4
    # (find_gates) — show the actual statistic and its curvature peaks
    mag = np.abs(np.gradient(np.gradient(stats)))
    gates = find_gates(bscan)
    dimg = bscan.T                                   # display: depth x scans
    data = {"N": int(dimg.shape[0]),
            "duration_ms": 8000,
            "stats": [float(v) for v in stats / max(stats.max(), 1e-6)],
            "mag": [float(v) for v in mag / max(mag.max(), 1e-6)],
            "thr": 1.0 / 4.0,                        # |d2| >= max(|d2|)/4
            "gates": [[int(a), int(b)] for a, b in gates],
            "img": _b64(dimg / max(dimg.max(), 1e-6)),
            "S": int(dimg.shape[1])}
    body = ('<div class="row"><canvas id="im" width="480" height="380">'
            '</canvas><canvas id="st" width="420" height="380"></canvas>'
            '</div><div class="legend">left: one beam (depth &times; '
            'scans) with detected gates shaded in. right: per-depth-row '
            'mean amplitude (the statistic), the derived threshold '
            '(dashed), and the gate bands that exceed it — wall echoes '
            'found with zero manual tuning.</div>')
    js = """
const im = document.getElementById('im').getContext('2d');
const st = document.getElementById('st').getContext('2d');
const img = u8(DATA.img);
function draw(t) {
  const N = DATA.N, S = DATA.S;
  im.clearRect(0, 0, 480, 380); st.clearRect(0, 0, 420, 380);
  const ch = 360 / N, cw = 460 / S;
  for (let n = 0; n < N; n++) for (let s = 0; s < S; s++) {
    const v = img[n * S + s] / 255;
    im.fillStyle = `rgb(${30 + 210 * v},${40 + 150 * v},90)`;
    im.fillRect(10 + s * cw, 10 + n * ch, cw, Math.max(1, ch));
  }
  // phase 1 (t<0.4): row stats sweep in; phase 2: curvature + threshold;
  // phase 3: gates
  const rows = Math.floor(Math.min(1, t / 0.4) * N);
  st.strokeStyle = '#6fd18a'; st.beginPath();
  for (let n = 0; n < rows; n++) {
    const x = 10 + 380 * DATA.stats[n], y = 10 + n * ch;
    if (n === 0) st.moveTo(x, y); else st.lineTo(x, y);
  }
  st.stroke();
  let label = 'scanning row statistics (mean |amplitude| per depth)';
  if (t > 0.45) {
    st.strokeStyle = '#ffd34d'; st.beginPath();
    for (let n = 0; n < N; n++) {
      const x = 10 + 380 * DATA.mag[n], y = 10 + n * ch;
      if (n === 0) st.moveTo(x, y); else st.lineTo(x, y);
    }
    st.stroke();
    const x = 10 + 380 * DATA.thr;
    st.setLineDash([6, 5]);
    st.beginPath(); st.moveTo(x, 10); st.lineTo(x, 370); st.stroke();
    st.setLineDash([]);
    label = 'curvature |d²stats| (yellow); peaks >= max/4 bound the gates';
  }
  if (t > 0.6) {
    const k = Math.floor((t - 0.6) / 0.4 * DATA.gates.length + 1e-9);
    for (let i = 0; i < Math.min(DATA.gates.length, k + 1); i++) {
      const [a, b] = DATA.gates[i];
      im.fillStyle = 'rgba(77,163,255,0.25)';
      im.fillRect(10, 10 + a * ch, 460, (b - a + 1) * ch);
      st.fillStyle = 'rgba(77,163,255,0.25)';
      st.fillRect(10, 10 + a * ch, 400, (b - a + 1) * ch);
    }
    label = `gates found: ${DATA.gates.map(g => g.join('-')).join(', ')}`;
  }
  document.getElementById('tlabel').textContent = label;
}
"""
    html_text = _page(
        "Autogates — finding wall echoes automatically",
        "Per-depth-row statistics locate the persistently-bright bands "
        "(front wall / back wall); everything between is the inspection "
        "gate. Algorithm: pautdx.utils.autogates.find_gates — the ported "
        "form of visualization/autogates_func.py; reference scene: "
        "autogates_visualization.py (manim).",
        body, data, js)
    with open(out_path, "w") as f:
        f.write(html_text)
    return out_path


def build_iou(out_path: str) -> str:
    data = {"duration_ms": 7000,
            "gt": [120, 90, 260, 220]}
    body = ('<canvas id="cv" width="640" height="320"></canvas>'
            '<div class="legend">green: ground truth. blue: prediction '
            'sliding across. shaded: intersection. IoU = intersection / '
            'union; the mAP@0.5 gates count a prediction correct when '
            'IoU &ge; 0.5.</div>')
    js = """
const cv = document.getElementById('cv').getContext('2d');
function draw(t) {
  cv.clearRect(0, 0, 640, 320);
  const [gx0, gy0, gx1, gy1] = DATA.gt;
  const w = 140, h = 130;
  const px0 = 20 + t * 380, py0 = 80 + 30 * Math.sin(t * 6.28);
  const px1 = px0 + w, py1 = py0 + h;
  const ix0 = Math.max(gx0, px0), iy0 = Math.max(gy0, py0);
  const ix1 = Math.min(gx1, px1), iy1 = Math.min(gy1, py1);
  const iw = Math.max(0, ix1 - ix0), ih = Math.max(0, iy1 - iy0);
  const inter = iw * ih;
  const union = (gx1 - gx0) * (gy1 - gy0) + w * h - inter;
  const iou = inter / union;
  if (inter > 0) { cv.fillStyle = 'rgba(255,211,77,0.45)';
                   cv.fillRect(ix0, iy0, iw, ih); }
  cv.strokeStyle = '#6fd18a'; cv.lineWidth = 2.5;
  cv.strokeRect(gx0, gy0, gx1 - gx0, gy1 - gy0);
  cv.strokeStyle = '#4da3ff';
  cv.strokeRect(px0, py0, w, h);
  cv.fillStyle = iou >= 0.5 ? '#6fd18a' : '#dfe7f1';
  cv.font = '20px system-ui';
  cv.fillText(`IoU = ${iou.toFixed(3)}${iou >= 0.5 ? '  >= 0.5: MATCH' : ''}`,
              420, 40);
  document.getElementById('tlabel').textContent =
    `intersection ${Math.round(inter)} px^2 / union ${Math.round(union)} px^2`;
}
"""
    html_text = _page(
        "IoU — the matching criterion behind mAP",
        "Intersection-over-union between a prediction and the ground "
        "truth, computed live as the prediction moves. Reference scene: "
        "visualization/iou_visualization.py (manim).",
        body, data, js)
    with open(out_path, "w") as f:
        f.write(html_text)
    return out_path


def build_pipeline(out_path: str) -> str:
    stages = [
        ["PAUT volume", "(beams, scans, samples)"],
        ["windows", "50-scan sequences per beam"],
        ["conv encoder", "k3/k3/k5 multi-scale, 256ch"],
        ["transformer", "4 layers x 8 heads, d=128"],
        ["per-signal head", "MLP 64 -> 1, sigmoid"],
        ["detections", "prob >= 0.5 per A-scan"],
    ]
    data = {"duration_ms": 8000, "stages": stages}
    body = ('<canvas id="pl" width="980" height="300"></canvas>'
            '<div class="legend">the HybridBinary/Complex signal '
            'pipeline, stage by stage; shapes are the real model '
            'dimensions (pautdx.models.signal).</div>')
    js = """
const pl = document.getElementById('pl').getContext('2d');
function draw(t) {
  pl.clearRect(0, 0, 980, 300);
  const n = DATA.stages.length;
  const vis = Math.min(n, Math.floor(t * (n + 0.999)) + 1);
  for (let i = 0; i < n; i++) {
    const x = 20 + i * 160, y = 100;
    const on = i < vis;
    pl.fillStyle = on ? '#1d2e45' : '#141a24';
    pl.strokeStyle = on ? '#4da3ff' : '#273244';
    pl.lineWidth = 2;
    pl.fillRect(x, y, 140, 84); pl.strokeRect(x, y, 140, 84);
    pl.fillStyle = on ? '#dfe7f1' : '#55657a';
    pl.font = 'bold 13px system-ui';
    pl.fillText(DATA.stages[i][0], x + 10, y + 28);
    pl.font = '11px system-ui';
    pl.fillText(DATA.stages[i][1], x + 10, y + 52);
    if (i > 0) {
      pl.strokeStyle = i < vis ? '#4da3ff' : '#273244';
      pl.beginPath(); pl.moveTo(x - 20, y + 42); pl.lineTo(x, y + 42);
      pl.stroke();
    }
  }
  document.getElementById('tlabel').textContent =
    DATA.stages[Math.min(n, vis) - 1][0];
}
"""
    html_text = _page(
        "Signal-detection pipeline — end to end",
        "From raw PAUT volume to per-signal defect probabilities. "
        "Reference scenes: visualization/detailed_neural_pipeline.py + "
        "signal_processing_animation.py (manim).",
        body, data, js)
    with open(out_path, "w") as f:
        f.write(html_text)
    return out_path


def build_position(out_path: str, seed: int = 7) -> str:
    """Position prediction: from a defect-bearing A-scan to a predicted
    (start, end) depth interval. The probability curve is the REAL
    normalized short-window energy of the generated signal (the matched-
    filter statistic the position heads learn to approximate); the
    predicted interval is its threshold crossing, scored against the GT
    interval with 1-D IoU — the exact quantity `pautdx.eval.iou`
    evaluates at IoU@t. (`signal_processing_animation.py` scene 6)"""
    spec, defects, vol = _demo_volume(seed)
    d = defects[0]
    beam = (d.beam_start + d.beam_end) // 2
    scan = (d.scan_start + d.scan_end) // 2
    sig = vol[beam, scan].astype(np.float64)
    N = sig.size
    # short-window energy, normalized — the matched-filter statistic
    w = 7
    pad = np.pad(sig ** 2, (w // 2, w // 2))
    energy = np.convolve(pad, np.ones(w), "valid")[:N]
    # suppress the wall echoes (outside the inspection gate)
    lo = int(spec.frontwall_pos * N) + 8
    hi = int(spec.backwall_pos * N) - 6
    gated = np.zeros(N)
    gated[lo:hi] = energy[lo:hi]
    prob = gated / max(gated.max(), 1e-9)
    thr = 0.35
    above = np.nonzero(prob >= thr)[0]
    pred = ([int(above[0]), int(above[-1])] if above.size
            else [0, 0])
    gt = [int(d.depth_start * N), int(d.depth_end * N)]
    inter = max(0, min(pred[1], gt[1]) - max(pred[0], gt[0]))
    union = max(pred[1], gt[1]) - min(pred[0], gt[0])
    data = {"duration_ms": 8000, "N": N,
            "sig": [round(float(v), 4) for v in sig],
            "prob": [round(float(v), 4) for v in prob],
            "thr": thr, "pred": pred, "gt": gt,
            "iou": round(inter / max(union, 1), 3)}
    body = ('<canvas id="cv" width="960" height="360"></canvas>'
            '<div class="legend">top: the A-scan (depth axis) with the '
            'ground-truth defect interval (green band). bottom: the '
            'normalized window-energy statistic sweeping in, the '
            'decision threshold (dashed), and the predicted (start, end) '
            'interval (blue band) scored with 1-D IoU — what the '
            'position heads (EnhancedPosition, DetLoc1D, seq detector) '
            'are trained to output.</div>')
    js = """
const cv = document.getElementById('cv').getContext('2d');
function draw(t) {
  cv.clearRect(0, 0, 960, 360);
  const N = DATA.N, X = n => 20 + 920 * n / N;
  // GT band (both panels)
  cv.fillStyle = 'rgba(111,209,138,0.18)';
  cv.fillRect(X(DATA.gt[0]), 10, X(DATA.gt[1]) - X(DATA.gt[0]), 340);
  // signal trace (top panel)
  cv.strokeStyle = '#dfe7f1'; cv.beginPath();
  for (let n = 0; n < N; n++) {
    const y = 90 - 70 * DATA.sig[n];
    if (n === 0) cv.moveTo(X(n), y); else cv.lineTo(X(n), y);
  }
  cv.stroke();
  // energy statistic sweeps in with t (bottom panel)
  const vis = Math.floor(Math.min(1, t / 0.6) * N);
  cv.strokeStyle = '#ffd34d'; cv.beginPath();
  for (let n = 0; n < vis; n++) {
    const y = 330 - 130 * DATA.prob[n];
    if (n === 0) cv.moveTo(X(n), y); else cv.lineTo(X(n), y);
  }
  cv.stroke();
  let label = 'computing window-energy statistic';
  if (t > 0.65) {
    const y = 330 - 130 * DATA.thr;
    cv.strokeStyle = '#8fa3b8'; cv.setLineDash([6, 5]);
    cv.beginPath(); cv.moveTo(20, y); cv.lineTo(940, y); cv.stroke();
    cv.setLineDash([]);
    label = `threshold ${DATA.thr}`;
  }
  if (t > 0.8) {
    cv.fillStyle = 'rgba(77,163,255,0.25)';
    cv.fillRect(X(DATA.pred[0]), 200,
                X(DATA.pred[1]) - X(DATA.pred[0]), 150);
    cv.fillStyle = '#dfe7f1'; cv.font = '16px system-ui';
    cv.fillText(`pred [${DATA.pred[0]}, ${DATA.pred[1]}]  vs  ` +
                `gt [${DATA.gt[0]}, ${DATA.gt[1]}]  ->  ` +
                `IoU ${DATA.iou}`, 320, 30);
    label = `1-D IoU = ${DATA.iou}`;
  }
  document.getElementById('tlabel').textContent = label;
}
"""
    html_text = _page(
        "Position prediction — (start, end) intervals from A-scans",
        "How a defect's depth extent is predicted per signal and scored "
        "with 1-D IoU@t. The statistic shown is the real window energy "
        "of a generated defect-bearing A-scan. Reference scene: "
        "visualization/signal_processing_animation.py (manim).",
        body, data, js)
    with open(out_path, "w") as f:
        f.write(html_text)
    return out_path


_SCENES = {
    "paut_structure.html": build_paut_structure,
    "signal_sequence.html": build_signal_sequence,
    "autogates.html": build_autogates,
    "iou.html": build_iou,
    "pipeline.html": build_pipeline,
    "position.html": build_position,
}


def build_explainers(out_dir: str) -> List[str]:
    """Write every explainer scene + an index.html; returns the paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for name, build in _SCENES.items():
        paths.append(build(os.path.join(out_dir, name)))
    links = "\n".join(
        f'<li><a href="{name}">{name[:-5].replace("_", " ")}</a></li>'
        for name in _SCENES)
    with open(os.path.join(out_dir, "index.html"), "w") as f:
        f.write(f"<!DOCTYPE html><html><head><meta charset='utf-8'>"
                f"<title>pautdx explainers</title><style>{_CSS}</style>"
                f"</head><body><h1>pautdx animated explainers</h1>"
                f"<p class='sub'>the reference's manim video suite, "
                f"re-rendered as dependency-free animated HTML.</p>"
                f"<ul>{links}</ul></body></html>")
    paths.append(os.path.join(out_dir, "index.html"))
    return paths
