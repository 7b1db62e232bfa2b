"""Interactive web viewer.

Port of ``gfnerf_tpu/viewer/server.py``, the substitute for the reference's
websocket viewer stack (``nerfstudio/viewer/``): a standard-library HTTP
server with an embedded orbit-control page.  The browser posts a camera
pose; the server renders it through the pipeline's ``render_camera`` (a
fast low-resolution pass while the user drags, a full one when idle) and
answers with a PNG from ``utils/image_io.encode_png``.

Camera paths: the page captures keyframes of the current view and exports
a slerp-interpolated ``camera_path.json`` in the reference's format, which
``python -m gfnerf_tpu_torch.render --traj filename`` reads.

Training controls: attached to a live Trainer, the server exposes the
reference viewer's training panel (``viewer_utils.py:65-280``: pause and
resume, stop and save, the step, loss and rays/s) through ``/status`` and
``/control``; the Trainer checks a shared :class:`TrainControl` between
steps.  Over several ranks rank 0 alone serves; at every step boundary
the ranks agree on its controls (:meth:`TrainControl.agree`, one
broadcast), a pause holds every rank in a poll of one such broadcast
every ``POLL_S``, and a render that would read a block table another
rank trained since the last sync waits until every rank has synced the
tables (:meth:`TrainControl.request_sync`).

Threads: renders run on the server's threads while the Trainer's Adam
updates the tables in place, so the Trainer hands the server the lock it
holds around each step, and a render takes it too (and enters
``torch.no_grad()``: grad mode is per thread).  Renders use the
pipeline's current step, so a run in its focal stage renders through its
block tables (the JAX viewer renders at step 0, the init stage).

Endpoints: ``GET /`` (the page), ``/status[?history=1]``, ``/scene``,
``/camera_paths[?name=N]``; ``POST /render``, ``/camera_path``,
``/control``, ``/export`` (the command line of
``python -m gfnerf_tpu_torch.export`` for a mode).

Usage: ``python -m gfnerf_tpu_torch.viewer --load-config RUN/config.json``.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from gfnerf_tpu_torch.exporter.exporter import train_outputs
from gfnerf_tpu_torch.utils.colormaps import (apply_colormap,
                                              apply_depth_colormap)
from gfnerf_tpu_torch.utils.image_io import encode_png

# the page's export modes and the exporter's names for them
EXPORT_MODES = {"pointcloud": "pointcloud", "poses": "poses",
                "mesh": "mesh", "tsdf": "tsdf", "textured": "texture"}


class Agreed(NamedTuple):
    """The controls every rank acts on at a step boundary: rank 0's
    ``paused``, ``stop`` and pending render sync, and (rank 0's) the last
    render request the sync covers."""
    paused: bool
    stop: bool
    sync: bool
    ticket: int


class TrainControl:
    """State shared by the viewer's threads and the Trainer's loop.

    The viewer sets ``paused`` and ``stop`` from its handlers; the Trainer
    calls :meth:`wait_if_paused` between steps and publishes its metrics
    into ``status`` (the reference's training-state machine,
    ``viewer_utils.py:65-280``, without the websocket bridge).  Over
    several ranks the Trainer calls :meth:`agree` instead, and a render
    of stale block tables asks for a sync (:meth:`request_sync`), which
    the Trainer runs on every rank at its next boundary and acknowledges
    (:meth:`served`).
    """

    HISTORY_LEN = 240   # metric samples kept for the page's sparklines
    POLL_S = 0.2        # a paused loop's poll
    # seconds a render waits for the ranks' sync, and the loop for the
    # renders the sync released
    SYNC_WAIT_S = 120.0

    def __init__(self):
        self.paused = False
        self.stop = False          # stop and save at the next step boundary
        self.sync_pending = False  # a render waits for the tables' sync
        self.held = False          # the loop is held at a step boundary
        self.status: dict = {}     # latest published train metrics
        self.history: list = []    # bounded [{metric: value}] trail
        self._lock = threading.Lock()
        # render requests for a sync: raised, covered by a finished sync,
        # and those not yet rendered
        self._sync = threading.Condition()
        self._requested = 0
        self._served = 0
        self._rendering: set = set()

    def publish(self, **metrics):
        clean = {}
        for k, v in metrics.items():
            try:
                clean[k] = float(v)
            except (TypeError, ValueError):
                clean[k] = str(v)
        with self._lock:
            self.status.update(clean)
            if "step" in clean:
                self.history.append(clean)
                del self.history[:-self.HISTORY_LEN]

    def snapshot(self, with_history: bool = False) -> dict:
        with self._lock:
            doc = {**self.status, "paused": self.paused,
                   "stopping": self.stop}
            if with_history:
                doc["history"] = list(self.history)
            return doc

    def wait_if_paused(self, poll_s: float = 0.2):
        while self.paused and not self.stop:
            self.held = True
            time.sleep(poll_s)
        self.held = False

    def agree(self, comm) -> Agreed:
        """Every rank's controls as rank 0 holds them: ``paused``, ``stop``
        and the pending render sync packed into one int32 tensor and
        broadcast from rank 0 (``Comm.broadcast``).  Rank 0's pending flag
        is taken into this agreement, with the requests raised so far."""
        with self._sync:
            ticket = self._requested
            flags = [self.paused, self.stop, self.sync_pending]
            self.sync_pending = False
        t = torch.tensor(flags, dtype=torch.int32, device=comm.device)
        paused, stop, sync = (bool(v) for v in comm.broadcast(t).tolist())
        if comm.rank != 0:
            # rank 0 keeps its own: its handlers may have moved them since
            self.paused, self.stop = paused, stop
        return Agreed(paused, stop, sync, ticket)

    def request_sync(self) -> int:
        """A render's request for the ranks' sync of the block tables:
        raises the pending flag and waits until a sync that every rank
        joined after this call has finished; the request's ticket (hand
        it to :meth:`render_done` once rendered).  Raises TimeoutError
        after ``SYNC_WAIT_S``."""
        with self._sync:
            self._requested += 1
            ticket = self._requested
            self._rendering.add(ticket)
            self.sync_pending = True
            if not self._sync.wait_for(lambda: self._served >= ticket,
                                       self.SYNC_WAIT_S):
                self._rendering.discard(ticket)
                raise TimeoutError(
                    "the ranks did not sync the block tables for this "
                    f"render within {self.SYNC_WAIT_S} s")
        return ticket

    def render_done(self, ticket: int) -> None:
        """The request ``ticket``'s render has finished."""
        with self._sync:
            self._rendering.discard(ticket)
            self._sync.notify_all()

    def release(self) -> None:
        """Release every render waiting for a sync (the run has ended, its
        tables synced by the last checkpoint)."""
        with self._sync:
            self._served = self._requested
            self._sync.notify_all()

    def served(self, ticket: int) -> None:
        """After a sync every rank joined: release the renders whose
        requests it covers (up to ``ticket``) and wait (bounded by
        ``SYNC_WAIT_S``) until they have rendered, so that no step runs
        between the sync and their renders."""
        with self._sync:
            self._served = max(self._served, ticket)
            self._sync.notify_all()
            self._sync.wait_for(
                lambda: not any(t <= self._served for t in self._rendering),
                self.SYNC_WAIT_S)


_PAGE = """<!DOCTYPE html>
<html><head><title>gfnerf-tpu viewer</title><style>
body{margin:0;background:#111;color:#ddd;font-family:monospace}
#hud{position:fixed;top:8px;left:8px}
canvas{display:block;margin:auto;cursor:grab}
#side{position:fixed;top:8px;right:8px;width:240px;background:#1a1a1acc;
 padding:8px;max-height:92vh;overflow-y:auto;font-size:12px}
#side h4{margin:4px 0}
#camlist div{cursor:pointer;padding:1px 2px}
#camlist div:hover{background:#333}
#expout{word-break:break-all;background:#000;padding:4px;display:block;
 margin-top:4px;user-select:all}
</style></head><body>
<div id="hud">gfnerf-tpu viewer &mdash; drag: orbit, wheel: zoom, shift-drag: pan,
K: add keyframe &mdash; <span id="nkf">0 keyframes</span>
<button onclick="addKeyframe()">add keyframe</button>
<button onclick="clearKeyframes()">clear</button>
<button onclick="previewPath()">preview</button>
<button onclick="exportPath()">export camera_path.json</button>
<input id="pathname" size="7" placeholder="name">
<select id="loadsel"><option value="">saved paths</option></select>
<button onclick="loadSaved()">load</button>
<input type="file" id="pathfile" style="display:none" accept=".json"
 onchange="loadFile(this.files[0])">
<button onclick="document.getElementById('pathfile').click()">load file</button>
<label><input type="checkbox" id="smoothchk">smooth</label>
<label><input type="checkbox" id="loopchk">loop</label>
<select id="ressel" onchange="setRes()"><option>640x480</option>
<option>960x720</option><option>320x240</option></select>
<button onclick="toggleSide()">panel</button>
<select id="outsel" onchange="render(2)"><option>rgb</option>
<option>depth</option><option>accumulation</option></select>
<label><input type="checkbox" id="splitchk" onchange="render(2)">split</label>
<select id="outsel2" onchange="render(2)"><option>depth</option>
<option>rgb</option><option>accumulation</option></select>
<input type="range" id="splitpos" min="5" max="95" value="50"
 style="width:60px" oninput="render(2)">
fov <input type="range" id="fovsel" min="20" max="120" value="60"
 style="width:60px" onchange="fov=+this.value; render(2)">
<div id="train" style="display:none">train: <span id="stats"></span>
<button id="pauseBtn" onclick="control('pause')">pause</button>
<button onclick="control('stop')">stop + save</button>
<canvas id="spark" width="220" height="54"
 style="display:block;background:#000;margin-top:4px"></canvas></div></div>
<div id="side" style="display:none">
<h4>scene</h4><div id="octstats"></div>
<div id="camlist"></div>
<h4>keyframes</h4><div id="kflist"></div>
<h4>display</h4>
depth range <input id="cmapnear" size="4" placeholder="auto">
&ndash; <input id="cmapfar" size="4" placeholder="auto">
<button onclick="render(2)">apply</button>
<h4>export</h4>
<select id="expmode"><option>pointcloud</option><option>mesh</option>
<option>tsdf</option><option>textured</option><option>poses</option></select>
<input id="expdir" value="exports" size="12">
<button onclick="genExport()">generate command</button>
<code id="expout"></code>
</div>
<canvas id="c" width="640" height="480"></canvas>
<script>
const c = document.getElementById('c'), ctx = c.getContext('2d');
let az = 0.5, el = 0.4, radius = __RADIUS__, target = [0,0,0], fov = 60;
let busy = false, dirty = true, hiresTimer = null;
function pose() {
  const ce=Math.cos(el), se=Math.sin(el), ca=Math.cos(az), sa=Math.sin(az);
  const eye=[target[0]+radius*ce*ca, target[1]+radius*ce*sa, target[2]+radius*se];
  const f=[target[0]-eye[0],target[1]-eye[1],target[2]-eye[2]];
  const fl=Math.hypot(...f); f[0]/=fl;f[1]/=fl;f[2]/=fl;
  const up=[0,0,1];
  let r=[f[1]*up[2]-f[2]*up[1], f[2]*up[0]-f[0]*up[2], f[0]*up[1]-f[1]*up[0]];
  const rl=Math.hypot(...r); r[0]/=rl;r[1]/=rl;r[2]/=rl;
  const u=[r[1]*f[2]-r[2]*f[1], r[2]*f[0]-r[0]*f[2], r[0]*f[1]-r[1]*f[0]];
  return [[r[0],u[0],-f[0],eye[0]],[r[1],u[1],-f[1],eye[1]],[r[2],u[2],-f[2],eye[2]]];
}
function renderBody(scale, output) {
  const body = {c2w: pose(), width: c.width, height: c.height,
                downscale: scale, output: output, fov: fov};
  const nr = document.getElementById('cmapnear').value,
        fr = document.getElementById('cmapfar').value;
  if (nr !== '') body.cmap_near = +nr;
  if (fr !== '') body.cmap_far = +fr;
  return JSON.stringify(body);
}
async function fetchImg(scale, output) {
  const res = await fetch('/render', {method:'POST',
      body: renderBody(scale, output)});
  return createImageBitmap(await res.blob());
}
async function render(scale) {
  if (busy) { dirty = true; return; }
  busy = true;
  const img = await fetchImg(scale, document.getElementById('outsel').value);
  ctx.imageSmoothingEnabled = false;
  ctx.drawImage(img, 0, 0, c.width, c.height);
  if (document.getElementById('splitchk').checked) {
    // split-screen output compare (the reference viewer's "split" render
    // option): left = primary output, right = secondary, movable divider
    const img2 = await fetchImg(scale,
        document.getElementById('outsel2').value);
    const sx = c.width * (+document.getElementById('splitpos').value) / 100;
    ctx.save(); ctx.beginPath(); ctx.rect(sx, 0, c.width - sx, c.height);
    ctx.clip(); ctx.drawImage(img2, 0, 0, c.width, c.height); ctx.restore();
    ctx.strokeStyle = '#fff'; ctx.beginPath();
    ctx.moveTo(sx, 0); ctx.lineTo(sx, c.height); ctx.stroke();
  }
  drawCameras();
  busy = false;
  if (dirty) { dirty = false; render(4); }
  else if (scale > 1) {
    clearTimeout(hiresTimer);
    hiresTimer = setTimeout(() => render(1), 300);
  }
}
let sceneCams = null;
const CLUSTER_COLORS = ['#e6194b','#3cb44b','#ffe119','#4363d8','#f58231',
  '#911eb4','#46f0f0','#f032e6','#bcf60c','#fabebe'];
async function drawCameras() {
  // project train-camera positions + view ticks into the current view —
  // the 2D form of the reference client's camera frustum objects
  if (!document.getElementById('showcams').checked) return;
  if (!sceneCams) {
    const sc = await (await fetch('/scene')).json();
    sceneCams = sc.cameras || [];
  }
  const p = pose();                       // c2w of the current view
  const eye = [p[0][3], p[1][3], p[2][3]];
  // world->cam: rows of R^T, t = -R^T eye
  const focal = c.height / 2 / Math.tan(fov * Math.PI / 360);
  const proj = w => {
    const d = [w[0]-eye[0], w[1]-eye[1], w[2]-eye[2]];
    const x = p[0][0]*d[0]+p[1][0]*d[1]+p[2][0]*d[2];
    const y = p[0][1]*d[0]+p[1][1]*d[1]+p[2][1]*d[2];
    const z = p[0][2]*d[0]+p[1][2]*d[1]+p[2][2]*d[2];
    if (z > -1e-3) return null;           // behind the view (-z forward)
    return [c.width/2 + focal*x/(-z), c.height/2 - focal*y/(-z)];
  };
  for (const cam of sceneCams) {
    const o = [cam.c2w[0][3], cam.c2w[1][3], cam.c2w[2][3]];
    const f = [-cam.c2w[0][2], -cam.c2w[1][2], -cam.c2w[2][2]];
    const s = proj(o);
    if (!s) continue;
    const tip = proj([o[0]+f[0]*0.4, o[1]+f[1]*0.4, o[2]+f[2]*0.4]);
    ctx.strokeStyle = ctx.fillStyle = cam.cluster === null ? '#0f0'
        : CLUSTER_COLORS[cam.cluster % CLUSTER_COLORS.length];
    ctx.beginPath(); ctx.arc(s[0], s[1], 3, 0, 2*Math.PI); ctx.fill();
    if (tip) { ctx.beginPath(); ctx.moveTo(s[0], s[1]);
               ctx.lineTo(tip[0], tip[1]); ctx.stroke(); }
  }
}
let drag=null;
c.onmousedown = e => drag = [e.clientX, e.clientY, e.shiftKey];
window.onmouseup = () => drag = null;
window.onmousemove = e => {
  if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  if (drag[2]) { target[0] -= dx*radius*0.001; target[2] += dy*radius*0.001; }
  else { az -= dx*0.01; el = Math.min(1.5, Math.max(-1.5, el + dy*0.01)); }
  drag = [e.clientX, e.clientY, drag[2]];
  render(4);
};
c.onwheel = e => { e.preventDefault(); radius *= Math.exp(e.deltaY*0.001); render(4); };
function setRes() {
  const [w, h] = document.getElementById('ressel').value.split('x');
  c.width = +w; c.height = +h; render(2);
}
const keyframes = [];
function kfStates() {  // orbit state per keyframe so jump is exact
  return {az, el, radius, target: target.slice(), fov};
}
const kfOrbit = [];
function refreshKf() {
  document.getElementById('nkf').textContent = keyframes.length + ' keyframes';
  const list = document.getElementById('kflist');
  if (!list) return;
  list.innerHTML = '';
  keyframes.forEach((kf, i) => {
    const d = document.createElement('div');
    d.textContent = 'kf ' + i + ' (fov ' + kfOrbit[i].fov + ')';
    d.onclick = () => { const o = kfOrbit[i]; az=o.az; el=o.el;
      radius=o.radius; target=o.target.slice(); fov=o.fov;
      document.getElementById('fovsel').value = fov; render(2); };
    const x = document.createElement('span');
    x.textContent = ' ×'; x.style.color = '#f66';
    x.onclick = ev => { ev.stopPropagation(); keyframes.splice(i, 1);
      kfOrbit.splice(i, 1); refreshKf(); };
    d.appendChild(x);
    list.appendChild(d);
  });
}
function addKeyframe() {
  keyframes.push(pose());
  kfOrbit.push(kfStates());
  refreshKf();
}
function clearKeyframes() {
  keyframes.length = 0; kfOrbit.length = 0;
  refreshKf();
}
async function previewPath() {
  // client-side fly-through of the captured path: slerp between orbit
  // states at low res (the camera-path editor's preview, sans three.js)
  if (kfOrbit.length < 2) { alert('need >= 2 keyframes'); return; }
  const save = kfStates();
  for (let i = 0; i + 1 < kfOrbit.length; i++) {
    for (let t = 0; t < 1; t += 0.2) {
      const a = kfOrbit[i], b = kfOrbit[i + 1];
      az = a.az + (b.az - a.az) * t; el = a.el + (b.el - a.el) * t;
      radius = a.radius + (b.radius - a.radius) * t;
      target = a.target.map((v, k) => v + (b.target[k] - v) * t);
      fov = a.fov + (b.fov - a.fov) * t;
      while (busy) await new Promise(r => setTimeout(r, 30));
      await render(8);
    }
  }
  az=save.az; el=save.el; radius=save.radius; target=save.target.slice();
  fov=save.fov;
  render(2);
}
async function exportPath() {
  if (keyframes.length < 2) { alert('need >= 2 keyframes'); return; }
  const loop = document.getElementById('loopchk').checked;
  const name = document.getElementById('pathname').value;
  const res = await fetch('/camera_path', {method:'POST', body: JSON.stringify(
    {keyframes: keyframes, width: c.width, height: c.height,
     fovs: kfOrbit.map(o => o.fov), orbit_states: kfOrbit, name: name,
     smooth: document.getElementById('smoothchk').checked, loop: loop,
     fps: 24, seconds: 2 * (keyframes.length - (loop ? 0 : 1))})});
  const blob = await res.blob();
  const a = document.createElement('a');
  a.href = URL.createObjectURL(blob);
  a.download = (name || 'camera_path') + '.json';
  a.click();
  refreshSavedPaths();
}
function orbitFromMatrix(m, kfFov) {
  // m: row-major flattened 4x4 camera-to-world ([r u -f eye] columns).
  // The orbit state has one free parameter a bare pose can't pin down
  // (the look-at distance); reuse the current orbit radius for it.
  const f = [-m[2], -m[6], -m[10]];
  const eye = [m[3], m[7], m[11]];
  return {az: Math.atan2(-f[1], -f[0]), el: Math.asin(Math.max(-1,
            Math.min(1, -f[2]))), radius: radius,
          target: [eye[0] + f[0]*radius, eye[1] + f[1]*radius,
                   eye[2] + f[2]*radius],
          fov: kfFov || fov};
}
function loadPathDoc(doc) {
  // LoadPathModal equivalent: restore the keyframe editor from a saved
  // camera_path.json. Priority: exact editor state (orbit_states, our
  // export extension) > stored keyframes (reference schema) > subsampled
  // camera_path frames (foreign files with no keyframe record).
  keyframes.length = 0; kfOrbit.length = 0;
  const kf4ToPose = m => [[m[0],m[1],m[2],m[3]], [m[4],m[5],m[6],m[7]],
                          [m[8],m[9],m[10],m[11]]];
  if (doc.orbit_states && doc.keyframes
      && doc.orbit_states.length === doc.keyframes.length) {
    doc.keyframes.forEach((kf, i) => {
      keyframes.push(kf4ToPose(kf.matrix));
      kfOrbit.push(doc.orbit_states[i]);
    });
  } else if (doc.keyframes && doc.keyframes.length) {
    doc.keyframes.forEach(kf => {
      keyframes.push(kf4ToPose(kf.matrix));
      kfOrbit.push(orbitFromMatrix(kf.matrix, kf.fov));
    });
  } else if (doc.camera_path && doc.camera_path.length) {
    const n = doc.camera_path.length;
    const stride = Math.max(1, Math.round((doc.fps || 24) * 2));
    for (let i = 0; i < n; i += stride) {
      const fr = doc.camera_path[i];
      keyframes.push(kf4ToPose(fr.camera_to_world));
      kfOrbit.push(orbitFromMatrix(fr.camera_to_world, fr.fov));
    }
  } else { alert('no keyframes or camera_path in file'); return; }
  if (doc.smoothness_value)
    document.getElementById('smoothchk').checked = true;
  if (doc.is_cycle) document.getElementById('loopchk').checked = true;
  refreshKf();
  if (kfOrbit.length) {
    const o = kfOrbit[0]; az=o.az; el=o.el; radius=o.radius;
    target=o.target.slice(); fov=o.fov;
    document.getElementById('fovsel').value = fov; render(2);
  }
}
async function refreshSavedPaths() {
  try {
    const res = await fetch('/camera_paths');
    const doc = await res.json();
    const sel = document.getElementById('loadsel');
    sel.innerHTML = '<option value="">saved paths</option>';
    doc.paths.forEach(p => {
      const o = document.createElement('option');
      o.value = p; o.textContent = p; sel.appendChild(o);
    });
  } catch (e) {}
}
async function loadSaved() {
  const name = document.getElementById('loadsel').value;
  if (!name) return;
  const res = await fetch('/camera_paths?name=' + encodeURIComponent(name));
  if (!res.ok) { alert('load failed'); return; }
  loadPathDoc(await res.json());
}
function loadFile(file) {
  if (!file) return;
  const r = new FileReader();
  r.onload = () => loadPathDoc(JSON.parse(r.result));
  r.readAsText(file);
}
refreshSavedPaths();
window.onkeydown = e => { if (e.key === 'k') addKeyframe(); };
let sideLoaded = false;
async function toggleSide() {
  const s = document.getElementById('side');
  s.style.display = s.style.display === 'none' ? 'block' : 'none';
  if (sideLoaded || s.style.display === 'none') return;
  sideLoaded = true;
  const res = await fetch('/scene');
  const sc = await res.json();
  const st = [];
  if (sc.octree && sc.octree.n_nodes)
    st.push('octree: ' + sc.octree.n_nodes + ' nodes, '
            + sc.octree.n_leaves + ' leaves');
  if (sc.blocks && Object.keys(sc.blocks).length)
    st.push('blocks: ' + Object.entries(sc.blocks)
            .map(([k,v]) => k + ':' + v + ' cams').join(', '));
  document.getElementById('octstats').textContent = st.join(' | ');
  const list = document.getElementById('camlist');
  (sc.cameras || []).forEach(cam => {
    const d = document.createElement('div');
    d.textContent = 'cam ' + cam.index
        + (cam.cluster !== null ? ' [b' + cam.cluster + ']' : '')
        + ' ' + cam.name;
    d.onclick = () => jumpTo(cam.c2w);
    list.appendChild(d);
  });
}
function jumpTo(c2w) {
  // set orbit state so pose() reproduces the camera's position, looking
  // along its -z axis toward a target at the current radius
  const eye = [c2w[0][3], c2w[1][3], c2w[2][3]];
  const fwd = [-c2w[0][2], -c2w[1][2], -c2w[2][2]];
  target = [eye[0] + fwd[0]*radius, eye[1] + fwd[1]*radius,
            eye[2] + fwd[2]*radius];
  az = Math.atan2(eye[1]-target[1], eye[0]-target[0]);
  const dxy = Math.hypot(eye[0]-target[0], eye[1]-target[1]);
  el = Math.atan2(eye[2]-target[2], dxy);
  render(2);
}
async function genExport() {
  const res = await fetch('/export', {method:'POST', body: JSON.stringify({
    mode: document.getElementById('expmode').value,
    output_dir: document.getElementById('expdir').value})});
  const r = await res.json();
  document.getElementById('expout').textContent =
      r.ok ? r.command : ('error: ' + r.error);
}
let paused = false;
async function control(action) {
  if (action === 'pause' && paused) action = 'resume';
  await fetch('/control', {method:'POST', body: JSON.stringify({action})});
  pollStatus();
}
function drawSpark(hist) {
  // loss (amber) + rays/s (teal) sparklines over the retained history —
  // the reference client's training charts, one small canvas
  const sc = document.getElementById('spark'), g = sc.getContext('2d');
  g.clearRect(0, 0, sc.width, sc.height);
  const series = [['loss', '#fb5', 0], ['rays_per_sec', '#5df', 27]];
  for (const [key, color, y0] of series) {
    const v = hist.map(h => h[key]).filter(x => typeof x === 'number');
    if (v.length < 2) continue;
    const lo = Math.min(...v), hi = Math.max(...v), rng = hi - lo || 1;
    g.strokeStyle = color; g.beginPath();
    v.forEach((x, i) => {
      const px = i / (v.length - 1) * (sc.width - 34);
      const py = y0 + 24 - (x - lo) / rng * 22;
      i ? g.lineTo(px, py) : g.moveTo(px, py);
    });
    g.stroke();
    g.fillStyle = color; g.font = '9px monospace';
    g.fillText(key === 'loss' ? v[v.length-1].toFixed(3)
               : Math.round(v[v.length-1]), sc.width - 33, y0 + 12);
  }
}
async function pollStatus() {
  try {
    const res = await fetch('/status?history=1');
    const s = await res.json();
    if (!s.training) return;
    document.getElementById('train').style.display = 'inline';
    paused = s.paused;
    document.getElementById('pauseBtn').textContent =
        paused ? 'resume' : 'pause';
    const parts = [];
    if ('step' in s) parts.push('step ' + s.step);
    if ('loss' in s) parts.push('loss ' + s.loss.toFixed(4));
    if ('psnr' in s) parts.push('psnr ' + s.psnr.toFixed(2));
    if ('rays_per_sec' in s) parts.push(Math.round(s.rays_per_sec) + ' rays/s');
    if (s.stopping) parts.push('(stopping)');
    document.getElementById('stats').textContent = parts.join(' | ');
    if (s.history) drawSpark(s.history);
  } catch (e) {}
}
setInterval(pollStatus, 2000);
pollStatus();
render(2);
</script></body></html>"""


def _quat_from_mat(m: np.ndarray) -> np.ndarray:
    """Rotation matrix (3, 3) -> unit quaternion (w, x, y, z)."""
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        q = np.array([0.25 * s, (m[2, 1] - m[1, 2]) / s,
                      (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s])
    else:
        i = int(np.argmax(np.diag(m)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(m[i, i] - m[j, j] - m[k, k] + 1.0) * 2
        q = np.empty(4)
        q[0] = (m[k, j] - m[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (m[j, i] + m[i, j]) / s
        q[1 + k] = (m[k, i] + m[i, k]) / s
    return q / np.linalg.norm(q)


def _mat_from_quat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _slerp(q0: np.ndarray, q1: np.ndarray, t: float) -> np.ndarray:
    if np.dot(q0, q1) < 0:
        q1 = -q1
    d = np.clip(np.dot(q0, q1), -1.0, 1.0)
    if d > 0.9995:
        q = q0 + t * (q1 - q0)
    else:
        th = np.arccos(d)
        q = (np.sin((1 - t) * th) * q0 + np.sin(t * th) * q1) / np.sin(th)
    return q / np.linalg.norm(q)


def _catmull_rom(p0, p1, p2, p3, t: float):
    """The uniform Catmull-Rom point at t in [0, 1] on the segment p1 ->
    p2: the reference camera-path editor's "smoothness" spline."""
    t2, t3 = t * t, t * t * t
    return 0.5 * ((2.0 * p1) + (-p0 + p2) * t
                  + (2.0 * p0 - 5.0 * p1 + 4.0 * p2 - p3) * t2
                  + (-p0 + 3.0 * p1 - 3.0 * p2 + p3) * t3)


def _segment_params(n_frames: int, k: int, loop: bool):
    """Per-frame (segment index, local t) for a K-keyframe path.

    Open paths span K-1 segments with both ends hit exactly; loops span K
    segments (the last returns to keyframe 0), the final frame stopping
    just short of the wrap so that playback tiles."""
    segs = k if loop else k - 1
    for f in range(n_frames):
        u = (f / n_frames if loop else f / max(n_frames - 1, 1)) * segs
        i = min(int(u), segs - 1)
        yield i, u - i


def interpolate_keyframes(keyframes: np.ndarray, n_frames: int,
                          smooth: bool = False,
                          loop: bool = False) -> np.ndarray:
    """(K, 3, 4) keyframe poses -> (n_frames, 3, 4) path.

    Rotations slerp between adjacent keyframes; positions are linear, or
    with ``smooth`` follow a Catmull-Rom spline through the keyframes
    (clamped ends for open paths, cyclic for ``loop``)."""
    k = len(keyframes)
    quats = [_quat_from_mat(m[:3, :3]) for m in keyframes]
    pos = np.asarray([m[:3, 3] for m in keyframes], np.float64)

    def at(i: int) -> int:
        return i % k if loop else min(max(i, 0), k - 1)

    out = []
    for i, t in _segment_params(n_frames, k, loop):
        j = at(i + 1)
        rot = _mat_from_quat(_slerp(quats[i], quats[j], t))
        if smooth and k >= 3:
            p = _catmull_rom(pos[at(i - 1)], pos[i], pos[j], pos[at(i + 2)], t)
        else:
            p = (1 - t) * pos[i] + t * pos[j]
        out.append(np.concatenate([rot, p[:, None]], axis=-1))
    return np.stack(out).astype(np.float32)


def interpolate_scalars(values, n_frames: int, smooth: bool = False,
                        loop: bool = False) -> np.ndarray:
    """Per-keyframe scalars (e.g. fov) -> per-frame values, frame for frame
    as :func:`interpolate_keyframes` places the poses."""
    v = np.asarray(values, np.float64)
    k = len(v)

    def at(i: int) -> int:
        return i % k if loop else min(max(i, 0), k - 1)

    out = []
    for i, t in _segment_params(n_frames, k, loop):
        j = at(i + 1)
        if smooth and k >= 3:
            out.append(_catmull_rom(v[at(i - 1)], v[i], v[j], v[at(i + 2)], t))
        else:
            out.append((1 - t) * v[i] + t * v[j])
    return np.asarray(out, np.float32)


def build_camera_path(keyframes, width, height, fov_deg, fps=24,
                      seconds=None, fovs=None, smooth=False,
                      loop=False, orbit_states=None) -> dict:
    """A nerfstudio camera_path.json document (the schema that
    ``gfnerf_tpu_torch.render --traj filename`` and the reference's render
    script read).

    ``fovs``: an optional fov per keyframe (the reference editor's
    per-keyframe override); ``smooth`` and ``loop`` select Catmull-Rom
    positions and a closed path.  ``orbit_states`` (the page's state per
    keyframe) rides along so that the page can reload its keyframes (the
    reference's LoadPathModal round trip)."""
    keyframes = np.asarray(keyframes, np.float32).reshape(-1, 3, 4)
    k = len(keyframes)
    seconds = seconds if seconds else 2.0 * (k if loop else k - 1)
    n_frames = max(int(round(fps * seconds)), 2)
    path = interpolate_keyframes(keyframes, n_frames, smooth=smooth,
                                 loop=loop)
    if fovs is not None and len(fovs) == k:
        frame_fovs = interpolate_scalars(fovs, n_frames, smooth=smooth,
                                         loop=loop)
    else:
        fovs = [float(fov_deg)] * k
        frame_fovs = np.full((n_frames,), float(fov_deg), np.float32)
    bottom = np.broadcast_to(np.array([0, 0, 0, 1], np.float32),
                             (n_frames, 1, 4))
    c2w4 = np.concatenate([path, bottom], axis=1)
    kf4 = np.concatenate(
        [keyframes, np.broadcast_to(np.array([0, 0, 0, 1], np.float32),
                                    (k, 1, 4))], axis=1)
    doc = {
        "camera_type": "perspective",
        "render_height": int(height),
        "render_width": int(width),
        "fps": float(fps),
        "seconds": float(seconds),
        "smoothness_value": 1.0 if smooth else 0.0,
        "is_cycle": bool(loop),
        # keyframes as the reference editor stores them (matrix, fov and
        # aspect), so that paths survive an editor round trip
        "keyframes": [
            {"matrix": kf4[i].reshape(-1).tolist(),
             "fov": float(fovs[i]),
             "aspect": float(width) / float(height)}
            for i in range(k)
        ],
        "camera_path": [
            {"camera_to_world": c2w4[i].reshape(-1).tolist(),
             "fov": float(frame_fovs[i])}
            for i in range(n_frames)
        ],
    }
    if orbit_states is not None:
        doc["orbit_states"] = orbit_states
    return doc


def _safe_path_name(name) -> str:
    """A saved path's user-given name reduced to a bare file stem
    (letters, digits, '-' and '_': no path traversal from HTTP)."""
    if not name or not isinstance(name, str):
        return ""
    return "".join(ch for ch in name if ch.isalnum() or ch in "-_")[:64]


class ViewerServer:
    def __init__(self, pipeline, port: int = 7007,
                 default_radius: float = 4.0, fov_deg: float = 60.0,
                 save_dir: Optional[Path] = None,
                 control: Optional[TrainControl] = None,
                 host: str = "127.0.0.1",
                 lock: Optional[threading.Lock] = None):
        """``port`` 0 binds an ephemeral port (``self.port`` holds it once
        bound).  ``host`` defaults to loopback: ``/control`` can stop
        training and ``/camera_path`` writes files, so exposing every
        interface is an explicit choice (``--host 0.0.0.0``).  ``lock``:
        the Trainer's step lock, held around each render."""
        self.pipeline = pipeline
        self.port = port
        self.host = host
        self.default_radius = default_radius
        self.fov_deg = fov_deg
        self.save_dir = Path(save_dir) if save_dir else None
        self.control = control
        self._lock = lock if lock is not None else threading.Lock()
        self.httpd: Optional[ThreadingHTTPServer] = None

    def _status(self, with_history: bool = False) -> bytes:
        """The controls and the latest metrics; ``held``: the training
        loop waits at a step boundary under the pause."""
        doc = {"training": self.control is not None}
        if self.control is not None:
            doc.update(self.control.snapshot(with_history=with_history))
            doc["held"] = self.control.held
        return json.dumps(doc).encode()

    def _control(self, req: dict) -> bytes:
        action = req.get("action")
        if self.control is None:
            return b'{"ok": false, "error": "no live training attached"}'
        if action == "pause":
            self.control.paused = True
        elif action == "resume":
            self.control.paused = False
        elif action == "stop":
            self.control.stop = True
            self.control.paused = False
        else:
            return b'{"ok": false, "error": "unknown action"}'
        return b'{"ok": true}'

    def _scene(self) -> bytes:
        """The scene's JSON: the train cameras (click to jump), the octree's
        and the blocks' counts (the reference viewer's side-panel scene
        tree).  A vanilla pipeline has no octree and no blocks."""
        doc: dict = {"cameras": [], "octree": {}, "blocks": {}}
        pipe = self.pipeline
        if pipe is None:
            return json.dumps(doc).encode()
        try:
            outputs = train_outputs(pipe)
            c2w = np.asarray(outputs.cameras.camera_to_worlds)
            names = [str(f) for f in
                     (outputs.image_filenames or [""] * len(c2w))]
            sampler = getattr(pipe, "sampler", None)
            labels = (np.asarray(sampler.cameras_labels).reshape(-1).tolist()
                      if sampler is not None
                      and sampler.cameras_labels is not None else None)
            doc["cameras"] = [
                {"index": i,
                 "name": names[i].rsplit("/", 1)[-1] if i < len(names) else "",
                 "c2w": c2w[i].tolist(),
                 "cluster": labels[i] if labels else None}
                for i in range(len(c2w))
            ]
            if sampler is not None:
                doc["octree"] = {"n_nodes": int(sampler.tree.n_nodes),
                                 "n_leaves": int(sampler.oct_dev.n_leaves)}
                if labels:
                    counts = np.bincount(labels)
                    doc["blocks"] = {str(k): int(v)
                                     for k, v in enumerate(counts) if v}
        except Exception as e:  # scene info is best effort
            doc["error"] = str(e)
        return json.dumps(doc).encode()

    def _export_cmd(self, req: dict) -> bytes:
        """The exporter's command line for the requested mode (the
        reference's export panel likewise shows an ``ns-export`` command
        to run).  The page's "textured" is the exporter's "texture"."""
        mode = req.get("mode", "pointcloud")
        if mode not in EXPORT_MODES:
            return b'{"ok": false, "error": "unknown export mode"}'
        cfg = "<run>/config.json"
        if self.save_dir is not None:
            cfg = str(Path(self.save_dir) / "config.json")
        out_dir = req.get("output_dir", "exports")
        parts = ["python -m gfnerf_tpu_torch.export", EXPORT_MODES[mode],
                 f"--load-config {cfg}", f"--output-dir {out_dir}"]
        if mode in ("mesh", "tsdf", "textured"):
            parts.append(f"--resolution {int(req.get('resolution', 128))}")
            parts.append("--density-threshold "
                         f"{float(req.get('density_threshold', 5.0))}")
        return json.dumps({"ok": True, "command": " ".join(parts)}).encode()

    def _camera_path(self, req: dict) -> bytes:
        doc = build_camera_path(
            req["keyframes"], req.get("width", 640), req.get("height", 480),
            self.fov_deg, fps=req.get("fps", 24),
            seconds=req.get("seconds"), fovs=req.get("fovs"),
            smooth=bool(req.get("smooth")), loop=bool(req.get("loop")),
            orbit_states=req.get("orbit_states"))
        payload = json.dumps(doc, indent=2).encode()
        if self.save_dir is not None:
            self.save_dir.mkdir(parents=True, exist_ok=True)
            (self.save_dir / "camera_path.json").write_bytes(payload)
            name = _safe_path_name(req.get("name"))
            if name:
                d = self.save_dir / "camera_paths"
                d.mkdir(parents=True, exist_ok=True)
                (d / f"{name}.json").write_bytes(payload)
        return payload

    def _camera_paths_list(self) -> bytes:
        """The saved paths' names (the reference LoadPathModal's list)."""
        names = []
        if self.save_dir is not None:
            d = self.save_dir / "camera_paths"
            if d.is_dir():
                names = sorted(p.stem for p in d.glob("*.json"))
            if (self.save_dir / "camera_path.json").exists():
                names.insert(0, "camera_path")
        return json.dumps({"paths": names}).encode()

    def _camera_path_get(self, name: str) -> bytes:
        name = _safe_path_name(name)
        if not name or self.save_dir is None:
            raise FileNotFoundError(name)
        for cand in (self.save_dir / "camera_paths" / f"{name}.json",
                     self.save_dir / f"{name}.json"):
            if cand.exists():
                return cand.read_bytes()
        raise FileNotFoundError(name)

    def render_outputs(self, req: dict) -> dict:
        """The pipeline's ``render_camera`` outputs for a request's pose
        (``c2w`` (3, 4)), size, ``downscale`` and ``fov`` in degrees, at
        the pipeline's current step, under the step lock and without
        gradients.  Over several ranks, where this rank's block tables are
        stale (``tables_stale``: another block group trained one since the
        last sync), it first waits for a sync of every rank
        (``TrainControl.request_sync``) and renders before the next
        step."""
        from gfnerf_tpu_torch.data.dataparsers.base import CamerasHost

        c2w = np.asarray(req["c2w"], np.float32).reshape(1, 3, 4)
        w = int(req.get("width", 640))
        h = int(req.get("height", 480))
        down = int(req.get("downscale", 1))
        fov = float(req.get("fov", self.fov_deg))   # the page's fov slider
        focal = h / 2.0 / np.tan(np.deg2rad(fov) / 2.0)
        cams = CamerasHost(
            camera_to_worlds=c2w,
            fx=np.array([focal], np.float32), fy=np.array([focal], np.float32),
            cx=np.array([w / 2.0], np.float32),
            cy=np.array([h / 2.0], np.float32),
            width=np.array([w], np.int32), height=np.array([h], np.int32),
        )
        pipe = self.pipeline
        stale = getattr(pipe, "tables_stale", None)
        ticket = None
        try:
            while True:
                with self._lock, torch.no_grad():
                    if stale is None or not stale():
                        state = getattr(pipe, "state", None)
                        step = int(state.step) if state is not None else 0
                        cams_dev = cams.to_device(getattr(pipe, "device",
                                                          "cpu"))
                        return pipe.render_camera(cams, cams_dev, 0, step,
                                                  downscale=down)
                if ticket is not None or self.control is None:
                    raise RuntimeError("the block tables are stale and no "
                                       "sync of the ranks came")
                ticket = self.control.request_sync()
        finally:
            if ticket is not None:
                self.control.render_done(ticket)

    def _render(self, req: dict) -> bytes:
        """A request's render as PNG bytes: ``output`` rgb, depth or
        accumulation (the reference viewer's output selector), depth and
        accumulation colormapped as the trainer's eval images are;
        ``cmap_near``/``cmap_far`` fix the depth range (else the image's
        own)."""
        out = self.render_outputs(req)
        which = req.get("output", "rgb")
        if which == "depth" and "depth" in out:
            img = apply_depth_colormap(out["depth"], out.get("accumulation"),
                                       near=req.get("cmap_near"),
                                       far=req.get("cmap_far"))
        elif which == "accumulation" and "accumulation" in out:
            img = apply_colormap(out["accumulation"])
        else:
            img = out["rgb"]
        return encode_png(quantize(img))

    def make_server(self) -> ThreadingHTTPServer:
        """The HTTP server, bound (``self.port`` the bound port) and not yet
        serving."""
        viewer = self
        radius = self.default_radius

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.path in ("/status", "/status?history=1", "/scene"):
                    body = (viewer._scene() if self.path == "/scene"
                            else viewer._status(
                                with_history="history" in self.path))
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if self.path.startswith("/camera_paths"):
                    try:
                        if "?name=" in self.path:
                            body = viewer._camera_path_get(
                                self.path.split("?name=", 1)[1])
                        else:
                            body = viewer._camera_paths_list()
                        self.send_response(200)
                        self.send_header("Content-Type", "application/json")
                    except FileNotFoundError:
                        body = b"not found"
                        self.send_response(404)
                    self.end_headers()
                    self.wfile.write(body)
                    return
                page = _PAGE.replace("__RADIUS__", str(radius))
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.end_headers()
                self.wfile.write(page.encode())

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                try:
                    req = json.loads(self.rfile.read(n))
                    if self.path == "/camera_path":
                        body = viewer._camera_path(req)
                        ctype = "application/json"
                    elif self.path == "/control":
                        body = viewer._control(req)
                        ctype = "application/json"
                    elif self.path == "/export":
                        body = viewer._export_cmd(req)
                        ctype = "application/json"
                    else:
                        body = viewer._render(req)
                        ctype = "image/png"
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                    self.end_headers()
                    self.wfile.write(body)
                except Exception as e:  # render errors go to the client
                    self.send_response(500)
                    self.end_headers()
                    self.wfile.write(str(e).encode())

        self.httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self.httpd.server_address[1]
        return self.httpd

    def serve_forever(self):
        httpd = self.make_server()
        print(f"[viewer] serving on http://{self.host}:{self.port}",
              flush=True)
        httpd.serve_forever()

    def start(self) -> "ViewerServer":
        """Bind and serve from a daemon thread; returns self (its ``port``
        bound)."""
        httpd = self.make_server()
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        return self

    def shutdown(self):
        """Stop serving and close the socket."""
        if self.httpd is not None:
            self.httpd.shutdown()
            self.httpd.server_close()
            self.httpd = None


def quantize(img: np.ndarray) -> np.ndarray:
    """An image in [0, 1] as the 8-bit pixels ``/render`` encodes:
    clipped, scaled by 255 and truncated."""
    return (np.clip(np.asarray(img), 0, 1) * 255).astype(np.uint8)
