"""Live interactive viewer: browser-based render window.

The headless-environment equivalent of the reference's WPF render window
(Views/RenderWindow.xaml.cs:117-519): a continuously-rendering loop with
FPS / render-ms status (the RenderCompleted event, :64-66), runtime
photon-debug cycling (the P-key handler, :628), the composite DebugMode
selector (Composite.hlsl:184-371) and resolution switching
(MainWindow.xaml.cs:24-25, 1280x720 / 1920x1080).

Instead of a WriteableBitmap blit the frame travels as PNG over a local
HTTP socket to a browser page; keystrokes come back over the same socket.

Usage:
    python -m raytracevs_tpu_torch.api.viewer scene.rtvs [--port 8173] [--cpu]

The port of raytracevs_tpu/api/viewer.py: the same page, flags, key
commands and replies, on the port's Engine. It renders on the card; --cpu
runs the plain PyTorch pipeline, and without --cpu it raises when PyTorch
sees no CUDA device. While the loop runs, its render worker
(runtime/render_loop.py) is the only thread that touches tensors, on the
Engine device's current stream; a command that rebuilds the scene or the
Engine stops the loop (joins the worker) first and starts it after. The
HTTP threads read the PNG bytes under the lock.

Keys (in the browser):
    p        cycle photon debug mode (0-12)
    0-9      composite debug mode (0 = off)
    r        reset temporal history
    [ / ]    cycle resolution presets
    u / y    undo / redo property edits

The side panel is the property-editor analog (NodeEditorView property
panel + PropertyCommands): it lists the scene's node graph, lets you edit
any node's .rtvs-shaped properties as JSON while the scene renders, and
applies them through the undoable command stack (scene/commands.py);
"save .rtvs" writes the edited graph back with save_graph.
"""
from __future__ import annotations

import argparse
import json
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

RESOLUTIONS = [(640, 360), (1280, 720), (1920, 1080)]

_PAGE = """<!DOCTYPE html>
<html><head><title>raytracevs_tpu viewer</title><style>
body { background:#111; color:#ddd; font:13px monospace; margin:0;
       display:flex; flex-direction:column; height:100vh; }
#bar { padding:6px 10px; background:#1c1c1c; }
#main { display:flex; flex:1; min-height:0; }
#view { display:block; margin:0 auto; image-rendering:pixelated;
        max-width:100%; max-height:100%; object-fit:contain; }
#vwrap { flex:1; overflow:hidden; text-align:center; }
#panel { width:320px; background:#181818; overflow-y:auto; padding:8px;
         border-left:1px solid #333; }
#panel h4 { margin:8px 0 4px; color:#8cf; }
#graphwrap { height:42%; min-height:180px; border-top:1px solid #333;
             background:#141414; position:relative; }
#graphsvg { width:100%; height:100%; display:block; cursor:default; }
.nodebox { fill:#222a33; stroke:#49617a; stroke-width:1; rx:5; }
.nodebox.sel { stroke:#8cf; stroke-width:2; }
.nodetitle { fill:#cde; font:12px monospace; pointer-events:none; }
.nodetype { fill:#789; font:10px monospace; pointer-events:none; }
.sockname { fill:#9ab; font:10px monospace; pointer-events:none; }
.sock { stroke:#111; stroke-width:1; cursor:crosshair; }
.sock.compat { stroke:#8f8; stroke-width:2.5; }
.conn { fill:none; stroke:#7fa0c0; stroke-width:1.6; cursor:pointer; }
.conn:hover { stroke:#cf6060; stroke-width:2.5; }
.pending { fill:none; stroke:#8f8; stroke-width:1.5; stroke-dasharray:5 3;
           pointer-events:none; }
#boxsel { fill:rgba(120,160,255,0.12); stroke:#78a0ff; stroke-width:1;
          pointer-events:none; }
textarea { width:100%; height:150px; background:#0d0d0d; color:#cfc;
           font:12px monospace; border:1px solid #333; }
button { background:#333; color:#ddd; border:1px solid #555;
         border-radius:3px; margin:2px; cursor:pointer; }
kbd { background:#333; padding:1px 5px; border-radius:3px; }
#err { color:#f88; }
</style></head><body>
<div id="bar">connecting…</div>
<div id="main">
  <div id="vwrap"><img id="view" alt="render"></div>
  <div id="panel">
    <div>
      <button onclick="cmd('op=undo')">undo</button>
      <button onclick="cmd('op=redo')">redo</button>
      <button onclick="cmd('op=save')">save .rtvs</button>
      <button onclick="cmd('op=screenshot')">screenshot</button>
      <button onclick="loadGraph()">refresh</button>
    </div>
    <div>
      <select id="ntype"></select>
      <button onclick="addNode()">add node</button>
    </div>
    <div id="err"></div>
    <h4 id="seltitle"></h4>
    <textarea id="props" style="display:none" spellcheck="false"></textarea>
    <button id="apply" style="display:none" onclick="applyProps()">apply</button>
    <button id="delnode" style="display:none" onclick="delSelected()">delete</button>
  </div>
</div>
<div id="graphwrap"><svg id="graphsvg">
  <g id="vp"></g><rect id="boxsel" style="display:none"></rect>
</svg></div>
<div id="bar2" style="padding:6px 10px">
<kbd>p</kbd> photon &nbsp; <kbd>0-9</kbd> debug &nbsp; <kbd>r</kbd> reset
&nbsp; <kbd>[</kbd>/<kbd>]</kbd> resolution &nbsp; <kbd>del</kbd> delete sel
&nbsp; drag sockets to connect · drag canvas to box-select · alt/middle-drag
pans · wheel zooms</div>
<script>
const img = document.getElementById('view');
const bar = document.getElementById('bar');
const SVGNS = 'http://www.w3.org/2000/svg';
let busy = false, graph = null, sel = new Set();
let viewT = {x: 40, y: 30, k: 1};  // pan/zoom (PanZoomHandler analog)
async function tick() {
  if (!busy) {
    busy = true;
    try {
      const r = await fetch('/frame.png?t=' + Date.now());
      if (r.ok) {
        const blob = await r.blob();
        const url = URL.createObjectURL(blob);
        img.onload = () => URL.revokeObjectURL(url);
        img.src = url;
      }
      const s = await (await fetch('/status')).json();
      bar.textContent =
        `${s.width}x${s.height}  |  ${s.fps.toFixed(1)} FPS  |  ` +
        `${s.render_ms.toFixed(1)} ms/frame  |  frame ${s.frames}  |  ` +
        `backend ${s.backend}  |  debug ${s.debug_mode}  |  ` +
        `photon ${s.photon_debug_mode}`;
    } catch (e) { bar.textContent = 'disconnected: ' + e; }
    busy = false;
  }
  setTimeout(tick, 100);
}
tick();
async function cmd(q) {
  const out = await (await fetch('/cmd?' + q)).json();
  document.getElementById('err').textContent = out.error || '';
  await loadGraph();
  return out;
}
// ---- node-graph canvas (NodeEditorView.xaml.cs analog) --------------------
const TYPECOL = {OBJECT:'#e0a060', VECTOR3:'#70b0e0', FLOAT:'#a0d0a0',
  COLOR:'#e0e070', MATERIAL:'#c080d0', CAMERA:'#80d0d0', LIGHT:'#f0f0a0',
  SCENE:'#f08080', TRANSFORM:'#b0b0f0'};
const NW = 150, ROWH = 17, HEADH = 30;
function nodeH(n) {
  return HEADH + ROWH * Math.max(n.inputs.length, n.outputs.length) + 6;
}
function sockPos(n, name, isInput) {
  const list = isInput ? n.inputs : n.outputs;
  const i = list.findIndex(s => s.name === name);
  return {x: n.x + (isInput ? 0 : NW),
          y: n.y + HEADH + ROWH * i + ROWH / 2};
}
function compatible(a, b) {
  if (a === b) return true;  // sockets_compatible (scene/graph.py:33-41)
  const p = [a, b].sort().join();
  return p === 'COLOR,VECTOR3';
}
function bezier(p1, p2) {
  const dx = Math.max(Math.abs(p2.x - p1.x) / 2, 30);
  return `M ${p1.x} ${p1.y} C ${p1.x + dx} ${p1.y}, ` +
         `${p2.x - dx} ${p2.y}, ${p2.x} ${p2.y}`;
}
function el(tag, attrs, cls) {
  const e = document.createElementNS(SVGNS, tag);
  for (const k in attrs) e.setAttribute(k, attrs[k]);
  if (cls) e.setAttribute('class', cls);
  return e;
}
function renderCanvas() {
  const vp = document.getElementById('vp');
  vp.setAttribute('transform',
    `translate(${viewT.x},${viewT.y}) scale(${viewT.k})`);
  vp.innerHTML = '';
  if (!graph) return;
  for (const c of graph.connections) {
    const on = graph.nodes.find(n => n.id === c.out_node);
    const inn = graph.nodes.find(n => n.id === c.in_node);
    if (!on || !inn) continue;
    const p = el('path', {d: bezier(sockPos(on, c.out_sock, false),
                                    sockPos(inn, c.in_sock, true))}, 'conn');
    p.addEventListener('mousedown', ev => { ev.stopPropagation();
      cmd('op=disconnect&in_node=' + c.in_node +
          '&in_sock=' + encodeURIComponent(c.in_sock)); });
    const t = document.createElementNS(SVGNS, 'title');
    t.textContent = c.from + ' → ' + c.to + '  (click to disconnect)';
    p.appendChild(t);
    vp.appendChild(p);
  }
  for (const n of graph.nodes) {
    const g = el('g', {transform: `translate(${n.x},${n.y})`});
    const box = el('rect', {width: NW, height: nodeH(n) , rx: 5},
                   'nodebox' + (sel.has(n.id) ? ' sel' : ''));
    box.addEventListener('mousedown', ev => startNodeDrag(ev, n));
    g.appendChild(box);
    const title = el('text', {x: 8, y: 14}, 'nodetitle');
    title.textContent = n.title;
    g.appendChild(title);
    const ty = el('text', {x: 8, y: 25}, 'nodetype');
    ty.textContent = n.type;
    g.appendChild(ty);
    n.inputs.forEach((s, i) => {
      const y = HEADH + ROWH * i + ROWH / 2;
      const c = el('circle', {cx: 0, cy: y, r: 4.5,
        fill: TYPECOL[s.type] || '#999', 'data-node': n.id,
        'data-sock': s.name, 'data-input': '1', 'data-type': s.type}, 'sock');
      c.addEventListener('mousedown', ev => startConnect(ev, n, s, true));
      g.appendChild(c);
      const t = el('text', {x: 8, y: y + 3}, 'sockname');
      t.textContent = s.name; g.appendChild(t);
    });
    n.outputs.forEach((s, i) => {
      const y = HEADH + ROWH * i + ROWH / 2;
      const c = el('circle', {cx: NW, cy: y, r: 4.5,
        fill: TYPECOL[s.type] || '#999', 'data-node': n.id,
        'data-sock': s.name, 'data-input': '0', 'data-type': s.type}, 'sock');
      c.addEventListener('mousedown', ev => startConnect(ev, n, s, false));
      g.appendChild(c);
      const t = el('text', {x: NW - 8, y: y + 3, 'text-anchor': 'end'},
                   'sockname');
      t.textContent = s.name; g.appendChild(t);
    });
    vp.appendChild(g);
  }
}
function svgPoint(ev) {
  const r = document.getElementById('graphsvg').getBoundingClientRect();
  return {x: (ev.clientX - r.left - viewT.x) / viewT.k,
          y: (ev.clientY - r.top - viewT.y) / viewT.k};
}
let drag = null;  // {kind:'node'|'pan'|'box'|'conn', ...}
function startNodeDrag(ev, n) {
  ev.stopPropagation(); ev.preventDefault();
  if (ev.altKey) return;
  if (!sel.has(n.id)) { sel = ev.shiftKey ? sel.add(n.id) : new Set([n.id]); }
  showProps(n.id);
  const p = svgPoint(ev);
  drag = {kind: 'node', start: p, moved: false,
          orig: graph.nodes.filter(m => sel.has(m.id))
                     .map(m => ({id: m.id, x: m.x, y: m.y}))};
  renderCanvas();
}
function markCompat(n, s, isInput) {
  // highlight type-compatible drop targets (ConnectionHandler.cs:342-354);
  // must be re-applied after every renderCanvas() during the drag (the
  // canvas rebuild recreates the socket elements without the class)
  for (const c of document.querySelectorAll('.sock')) {
    if (c.getAttribute('data-input') === (isInput ? '0' : '1') &&
        c.getAttribute('data-node') !== n.id &&
        compatible(c.getAttribute('data-type'), s.type))
      c.classList.add('compat');
  }
}
function startConnect(ev, n, s, isInput) {
  ev.stopPropagation(); ev.preventDefault();
  drag = {kind: 'conn', node: n, sock: s, isInput: isInput, pos: svgPoint(ev)};
  markCompat(n, s, isInput);
}
const svg = document.getElementById('graphsvg');
svg.addEventListener('mousedown', ev => {
  const p = svgPoint(ev);
  if (ev.button === 1 || ev.altKey) {
    drag = {kind: 'pan', sx: ev.clientX, sy: ev.clientY,
            ox: viewT.x, oy: viewT.y};
    ev.preventDefault();
  } else if (ev.button === 0) {
    drag = {kind: 'box', start: p, cur: p};  // SelectionHandler.cs analog
    if (!ev.shiftKey) { sel = new Set(); renderCanvas(); }
  }
});
svg.addEventListener('wheel', ev => {
  ev.preventDefault();
  const r = svg.getBoundingClientRect();
  const mx = ev.clientX - r.left, my = ev.clientY - r.top;
  const k2 = Math.min(3, Math.max(0.2, viewT.k * Math.pow(1.0015, -ev.deltaY)));
  viewT.x = mx - (mx - viewT.x) * k2 / viewT.k;
  viewT.y = my - (my - viewT.y) * k2 / viewT.k;
  viewT.k = k2;
  renderCanvas();
});
document.addEventListener('mousemove', ev => {
  if (!drag) return;
  if (drag.kind === 'pan') {
    viewT.x = drag.ox + ev.clientX - drag.sx;
    viewT.y = drag.oy + ev.clientY - drag.sy;
    renderCanvas();
  } else if (drag.kind === 'node') {
    const p = svgPoint(ev);
    const dx = p.x - drag.start.x, dy = p.y - drag.start.y;
    if (Math.abs(dx) + Math.abs(dy) > 2) drag.moved = true;
    for (const o of drag.orig) {
      const n = graph.nodes.find(m => m.id === o.id);
      n.x = o.x + dx; n.y = o.y + dy;
    }
    renderCanvas();
  } else if (drag.kind === 'conn') {
    drag.pos = svgPoint(ev);
    renderCanvas();
    markCompat(drag.node, drag.sock, drag.isInput);
    const a = drag.isInput ? drag.pos
            : sockPos(drag.node, drag.sock.name, false);
    const b = drag.isInput ? sockPos(drag.node, drag.sock.name, true)
            : drag.pos;
    document.getElementById('vp').appendChild(
      el('path', {d: bezier(a, b)}, 'pending'));
  } else if (drag.kind === 'box') {
    drag.cur = svgPoint(ev);
    const bs = document.getElementById('boxsel');
    const x1 = Math.min(drag.start.x, drag.cur.x) * viewT.k + viewT.x;
    const y1 = Math.min(drag.start.y, drag.cur.y) * viewT.k + viewT.y;
    bs.style.display = 'block';
    bs.setAttribute('x', x1); bs.setAttribute('y', y1);
    bs.setAttribute('width', Math.abs(drag.cur.x - drag.start.x) * viewT.k);
    bs.setAttribute('height', Math.abs(drag.cur.y - drag.start.y) * viewT.k);
  }
});
document.addEventListener('mouseup', ev => {
  if (!drag) return;
  const d = drag; drag = null;
  if (d.kind === 'node' && d.moved) {
    const moves = d.orig.map(o => {
      const n = graph.nodes.find(m => m.id === o.id);
      return {node: o.id, x: n.x, y: n.y};
    });
    cmd('op=move&moves=' + encodeURIComponent(JSON.stringify(moves)));
  } else if (d.kind === 'conn') {
    const t = ev.target;
    if (t.classList && t.classList.contains('sock') &&
        t.getAttribute('data-input') === (d.isInput ? '0' : '1') &&
        t.getAttribute('data-node') !== d.node.id &&
        compatible(t.getAttribute('data-type'), d.sock.type)) {
      const on = d.isInput ? t.getAttribute('data-node') : d.node.id;
      const os = d.isInput ? t.getAttribute('data-sock') : d.sock.name;
      const inn = d.isInput ? d.node.id : t.getAttribute('data-node');
      const ins = d.isInput ? d.sock.name : t.getAttribute('data-sock');
      cmd('op=connect&out_node=' + on + '&out_sock=' +
          encodeURIComponent(os) + '&in_node=' + inn +
          '&in_sock=' + encodeURIComponent(ins));
    } else renderCanvas();
    for (const c of document.querySelectorAll('.sock.compat'))
      c.classList.remove('compat');
  } else if (d.kind === 'box') {
    document.getElementById('boxsel').style.display = 'none';
    const x1 = Math.min(d.start.x, d.cur.x), x2 = Math.max(d.start.x, d.cur.x);
    const y1 = Math.min(d.start.y, d.cur.y), y2 = Math.max(d.start.y, d.cur.y);
    if (x2 - x1 > 3 || y2 - y1 > 3) {
      for (const n of graph.nodes)
        if (n.x < x2 && n.x + NW > x1 && n.y < y2 && n.y + nodeH(n) > y1)
          sel.add(n.id);
      if (sel.size === 1) showProps([...sel][0]);
    }
    renderCanvas();
  }
});
svg.addEventListener('contextmenu', ev => ev.preventDefault());
// ---- panel ----------------------------------------------------------------
async function loadGraph() {
  graph = await (await fetch('/graph')).json();
  const tsel = document.getElementById('ntype');
  if (!tsel.options.length)
    for (const t of graph.node_types)
      tsel.add(new Option(t, t));
  renderCanvas();
  if (sel.size === 1) showProps([...sel][0]);
}
function addNode() {
  const r = svg.getBoundingClientRect();
  const cx = (r.width / 2 - viewT.x) / viewT.k;
  const cy = (r.height / 2 - viewT.y) / viewT.k;
  cmd('op=addnode&type=' + document.getElementById('ntype').value +
      '&x=' + cx.toFixed(1) + '&y=' + cy.toFixed(1));
}
function delSelected() {
  if (!sel.size) return;
  cmd('op=delnodes&nodes=' + [...sel].join(','));
  sel = new Set();
  propsNode = null;
  document.getElementById('props').style.display = 'none';
  document.getElementById('apply').style.display = 'none';
  document.getElementById('delnode').style.display = 'none';
  document.getElementById('seltitle').textContent = '';
}
let propsNode = null;  // the node whose properties the panel displays —
                       // NOT [...sel][0]: with shift-multi-select the
                       // displayed node is the last clicked, and apply
                       // must edit exactly that one
function showProps(id) {
  const n = graph.nodes.find(n => n.id === id);
  if (!n) return;
  propsNode = id;
  document.getElementById('seltitle').textContent = 'edit: ' + n.title;
  const ta = document.getElementById('props');
  ta.style.display = 'block';
  ta.value = JSON.stringify(n.properties, null, 1);
  document.getElementById('apply').style.display = 'inline';
  document.getElementById('delnode').style.display = 'inline';
}
async function applyProps() {
  if (!propsNode) return;
  const ta = document.getElementById('props');
  try { JSON.parse(ta.value); } catch (e) { alert('bad JSON: ' + e); return; }
  await cmd('op=setprop&node=' + propsNode +
            '&props=' + encodeURIComponent(ta.value));
}
document.addEventListener('keydown', (e) => {
  if (e.target.tagName === 'TEXTAREA' || e.target.tagName === 'INPUT') return;
  let q = null;
  if (e.key === 'p' || e.key === 'P') q = 'op=photon';
  else if (e.key >= '0' && e.key <= '9') q = 'op=debug&mode=' + e.key;
  else if (e.key === 'r' || e.key === 'R') q = 'op=reset';
  else if (e.key === '[') q = 'op=res&dir=-1';
  else if (e.key === ']') q = 'op=res&dir=1';
  else if (e.key === 'u' || e.key === 'U') q = 'op=undo';
  else if (e.key === 'y' || e.key === 'Y') q = 'op=redo';
  else if (e.key === 'Delete' || e.key === 'Backspace') { delSelected(); return; }
  else if ((e.ctrlKey || e.metaKey) && (e.key === 'c' || e.key === 'C')) {
    if (sel.size) cmd('op=copy&nodes=' + [...sel].join(',')); return; }
  else if ((e.ctrlKey || e.metaKey) && (e.key === 'v' || e.key === 'V')) {
    cmd('op=paste'); return; }
  if (q) cmd(q);
});
loadGraph();
</script></body></html>"""


class ViewerState:
    """Shared state between the render loop and the HTTP handlers."""

    def __init__(self, scene_path: str, width: int, height: int,
                 overrides=None, device="cuda"):
        self.scene_path = scene_path
        self.overrides = dict(overrides or {})
        self.device = device
        self.lock = threading.Lock()
        # Serializes key-command handling: ThreadingHTTPServer runs each
        # request on its own thread, and cmd() stops/reloads/starts the
        # engine — two concurrent keystrokes must not interleave that.
        # Separate from self.lock (frame buffer): cmd holds cmd_lock while
        # loop.stop() joins the worker, whose on_frame takes self.lock.
        self.cmd_lock = threading.Lock()
        self.frame_png: bytes = b""
        self.render_ms = 0.0
        self.fps = 0.0
        self.frames = 0
        self.debug_mode = 0
        self.photon_debug_mode = int(self.overrides.get("photon_debug_mode", 0))
        self._last_frame_t = None
        self.engine = None
        self.loop = None
        self.graph = None
        from ..scene.commands import CommandManager

        self.cmds = CommandManager()
        self._start_engine(width, height)

    def _push_scene(self) -> None:
        """Evaluate the in-memory graph and hand the result to the engine."""
        from ..scene.evaluator import evaluate_scene

        ov = dict(self.overrides)
        ov["photon_debug_mode"] = self.photon_debug_mode
        if self.photon_debug_mode > 0:
            ov["enable_caustics"] = True
        self.engine.update_scene(evaluate_scene(self.graph), **ov)

    # -- engine lifecycle ---------------------------------------------------
    def _start_engine(self, width: int, height: int) -> None:
        from ..io.png import encode_png
        from ..runtime.engine import Engine
        from ..runtime.render_loop import RenderLoop

        if self.loop is not None:
            self.loop.stop()
        self.engine = Engine(width, height, device=self.device)
        if self.graph is None:
            # Load the node graph ONCE; every later rebuild (key commands,
            # property edits, undo/redo) re-evaluates the in-memory graph so
            # edits survive photon toggles and resolution switches.
            self.graph = self.engine.load_rtvs_graph(self.scene_path)
        self._push_scene()

        def on_frame(frame: np.ndarray, ms: float) -> None:
            # runs on the render worker; debug views render here too so the
            # engine is only ever touched from one thread
            if self.debug_mode > 0:
                frame = self.engine.render_debug_view(self.debug_mode)
            png = encode_png(frame, compress_level=1)
            now = time.perf_counter()
            with self.lock:
                self.frame_png = png
                self.render_ms = ms
                self.frames += 1
                if self._last_frame_t is not None:
                    dt = now - self._last_frame_t
                    if dt > 0:
                        self.fps = 0.8 * self.fps + 0.2 / dt if self.fps else 1.0 / dt
                self._last_frame_t = now

        self.loop = RenderLoop(self.engine, on_frame=on_frame)
        self.loop.continuous = True  # temporal accumulation keeps refining
        self.loop.start()
        self.loop.request_frame()

    # -- commands (the key handlers) ----------------------------------------
    def cmd(self, op: str, args: dict) -> dict:
        """Run one editor command; failures come back as a JSON error.

        A bad uuid, unknown node, or a property edit whose re-evaluation
        throws must never take the viewer down (or leave its render loop
        stopped) — mirror the reference editor's per-command exception
        guards. A mutation whose re-evaluation fails is rolled back via the
        command stack so the graph never stays in an unevaluable state.
        """
        with self.cmd_lock:
            try:
                return self._cmd(op, args)
            except Exception as e:  # noqa: BLE001 — report, don't crash
                from ..utils.logging import log_error

                log_error("viewer cmd %r failed: %s", op, e)
                return {"error": f"{type(e).__name__}: {e}", **self.status()}

    def _node_by_id(self, args: dict, key: str = "node"):
        """Validated node lookup: raises ValueError with a useful message."""
        raw = args.get(key, [""])[0]
        try:
            node_id = uuid.UUID(raw)
        except ValueError:
            raise ValueError(f"bad node id {raw!r}")
        node = next((n for n in self.graph.nodes if n.id == node_id), None)
        if node is None:
            raise ValueError(f"no node with id {raw}")
        return node

    def _rebuild(self, recover: str = "undo") -> None:
        # The engine is single-threaded: pause the worker around the scene
        # rebuild, exactly like the reference rebuilds pipeline state on
        # the UI thread. The loop restarts even when evaluation throws
        # (try/finally) so a bad edit can't freeze the viewer; the failed
        # mutation itself is undone by _cmd's caller via the command stack.
        # `recover` is the inverse of the operation that just mutated the
        # graph: "undo" for a forward edit/redo, "redo" when the caller was
        # itself an undo (rolling back an older, unrelated command would
        # leave the graph two edits behind the user's intent).
        self.loop.stop()
        try:
            self._push_scene()
        except Exception:
            # Invert the command that broke evaluation (if any) and
            # restore a renderable scene before re-raising to the JSON
            # error path.
            if recover == "redo":
                if self.cmds.can_redo:
                    self.cmds.redo()
                    self._push_scene()
            elif self.cmds.can_undo:
                self.cmds.undo()
                self._push_scene()
            raise
        finally:
            self.loop.start()
            self.loop.request_frame()

    def _cmd(self, op: str, args: dict) -> dict:
        if op == "photon":
            # P-key cycle (RenderWindow.xaml.cs:628): advance mode 0-12.
            self.photon_debug_mode = (self.photon_debug_mode + 1) % 13
            self._rebuild()
        elif op == "setprop":
            # Property-panel edit: .rtvs-shaped properties, undoable
            # (PropertyCommands + CommandManager, like the editor).
            from ..scene.commands import ApplyPropertiesCommand

            node = self._node_by_id(args)
            props = json.loads(args.get("props", ["{}"])[0])
            if not isinstance(props, dict):
                raise ValueError("props must be a JSON object")
            self.cmds.execute(ApplyPropertiesCommand(node, props))
            self._rebuild()
        elif op == "addnode":
            from ..models import NODE_TYPES
            from ..scene.commands import AddNodeCommand

            type_name = args.get("type", [""])[0]
            if type_name not in NODE_TYPES:
                raise ValueError(f"unknown node type {type_name!r}")
            node = NODE_TYPES[type_name]()
            # canvas drop position (palette drag / add-at-center)
            node.position = (float(args.get("x", ["0"])[0]),
                             float(args.get("y", ["0"])[0]))
            self.cmds.execute(AddNodeCommand(self.graph, node))
            self._rebuild()
        elif op == "delnode":
            from ..scene.commands import RemoveNodeCommand

            node = self._node_by_id(args)
            self.cmds.execute(RemoveNodeCommand(self.graph, node))
            self._rebuild()
        elif op == "delnodes":
            # canvas multi-delete: one composite undo entry for the whole
            # selection (EditCommandHandler.cs delete-selection analog)
            from ..scene.commands import CompositeCommand, RemoveNodeCommand

            ids = [i for i in args.get("nodes", [""])[0].split(",") if i]
            nodes = [self._node_by_id({"node": [i]}) for i in ids]
            if nodes:
                self.cmds.execute(CompositeCommand(
                    [RemoveNodeCommand(self.graph, n) for n in nodes],
                    description=f"delete {len(nodes)} node(s)"))
                self._rebuild()
        elif op == "move":
            # canvas drag end: JSON list [{node, x, y}] -> one undo entry
            # (NodeDragHandler registers the completed drag). Positions
            # don't affect rendering, so no scene rebuild.
            from ..scene.commands import MoveNodesCommand

            moves = json.loads(args.get("moves", ["[]"])[0])
            resolved = [
                (self._node_by_id({"node": [m["node"]]}),
                 (float(m["x"]), float(m["y"])))
                for m in moves
            ]
            if resolved:
                self.cmds.execute(MoveNodesCommand(resolved))
        elif op == "connect":
            from ..scene.commands import ConnectCommand

            out_n = self._node_by_id(args, "out_node")
            in_n = self._node_by_id(args, "in_node")
            out_s = out_n.find_output(args.get("out_sock", [""])[0])
            in_s = in_n.find_input(args.get("in_sock", [""])[0])
            if out_s is None or in_s is None:
                raise ValueError("no such socket")
            self.cmds.execute(ConnectCommand(self.graph, out_s, in_s))
            self._rebuild()
        elif op == "disconnect":
            from ..scene.commands import DisconnectCommand

            in_n = self._node_by_id(args, "in_node")
            in_s = in_n.find_input(args.get("in_sock", [""])[0])
            if in_s is None:
                raise ValueError("no such socket")
            conn = self.graph.connection_into(in_s)
            if conn is not None:
                self.cmds.execute(DisconnectCommand(self.graph, conn))
                self._rebuild()
        elif op == "copy":
            # serialize the selection to the server-side clipboard
            # (HandleCopy, NodeEditorView.xaml.cs:742-797)
            from ..scene.rtvs import copy_nodes

            ids = [i for i in args.get("nodes", [""])[0].split(",") if i]
            nodes = [self._node_by_id({"node": [i]}) for i in ids]
            self.clipboard = copy_nodes(self.graph, nodes)
            return {"copied": len(nodes), **self.status()}
        elif op == "paste":
            from ..scene.commands import PasteCommand

            if getattr(self, "clipboard", None):
                self.cmds.execute(PasteCommand(self.graph, self.clipboard))
                self._rebuild()
        elif op == "undo":
            if self.cmds.undo():
                self._rebuild(recover="redo")
        elif op == "redo":
            if self.cmds.redo():
                self._rebuild()
        elif op == "save":
            from ..scene.rtvs import save_graph

            save_graph(self.graph, self.scene_path)
        elif op == "screenshot":
            # save the current frame to the settings screenshot folder
            # (SettingsService.cs screenshot_folder; RenderWindow toolbar)
            import datetime
            import os

            from ..io.settings import SettingsService

            svc = SettingsService()
            svc.load()
            folder = svc.settings.screenshot_folder or os.path.join(
                os.path.expanduser("~"), ".raytracevs_tpu", "screenshots")
            os.makedirs(folder, exist_ok=True)
            name = datetime.datetime.now().strftime("render_%Y%m%d_%H%M%S.png")
            path = os.path.join(folder, name)
            with self.lock:
                png = self.frame_png
            if not png:
                raise ValueError("no frame rendered yet")
            with open(path, "wb") as f:
                f.write(png)
            return {"screenshot": path, **self.status()}
        elif op == "debug":
            self.debug_mode = max(0, min(10, int(args.get("mode", ["0"])[0])))
            self.loop.request_frame()
        elif op == "reset":
            # temporal-history reset (the scene-change analog)
            self.engine._denoise_state = None
            self.engine._checksum = None
            self.loop.request_frame()
        elif op == "res":
            d = int(args.get("dir", ["1"])[0])
            cur = (self.engine.width, self.engine.height)
            idx = RESOLUTIONS.index(cur) if cur in RESOLUTIONS else 0
            w, h = RESOLUTIONS[(idx + d) % len(RESOLUTIONS)]
            self._start_engine(w, h)
        return self.status()

    def graph_json(self) -> dict:
        """Node-graph snapshot for the editor panel (.rtvs property shapes)."""
        from ..scene.rtvs import _serialize_properties

        def sock(s):
            return {"name": s.name, "type": s.type.name}

        with self.cmd_lock:
            return {
                "nodes": [
                    {
                        "id": str(n.id),
                        "type": n.type_name,
                        "title": n.title,
                        "x": float(n.position[0]),
                        "y": float(n.position[1]),
                        "properties": _serialize_properties(n),
                        "inputs": [sock(s) for s in n.input_sockets],
                        "outputs": [sock(s) for s in n.output_sockets],
                    }
                    for n in self.graph.nodes
                ],
                "connections": [
                    {
                        "from": f"{c.output_node.title}.{c.output_socket.name}",
                        "to": f"{c.input_node.title}.{c.input_socket.name}",
                        "out_node": str(c.output_node.id),
                        "out_sock": c.output_socket.name,
                        "in_node": str(c.input_node.id),
                        "in_sock": c.input_socket.name,
                    }
                    for c in self.graph.connections
                ],
                "node_types": sorted(self._node_types()),
                "can_undo": self.cmds.can_undo,
                "can_redo": self.cmds.can_redo,
            }

    @staticmethod
    def _node_types():
        from ..models import NODE_TYPES

        return list(NODE_TYPES.keys())

    def status(self) -> dict:
        with self.lock:
            return {
                "width": self.engine.width,
                "height": self.engine.height,
                "fps": self.fps,
                "render_ms": self.render_ms,
                "frames": self.frames,
                "debug_mode": self.debug_mode,
                "photon_debug_mode": self.photon_debug_mode,
                "backend": self.engine.device.type,
                "rays": self.engine.last_rays,
            }


def make_server(state: ViewerState, port: int = 8173) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, ctype, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            try:
                if url.path == "/":
                    self._send(200, "text/html", _PAGE.encode())
                elif url.path == "/frame.png":
                    with state.lock:
                        png = state.frame_png
                    if not png:
                        self._send(503, "text/plain", b"no frame yet")
                    else:
                        self._send(200, "image/png", png)
                elif url.path == "/status":
                    self._send(200, "application/json",
                               json.dumps(state.status()).encode())
                elif url.path == "/graph":
                    self._send(200, "application/json",
                               json.dumps(state.graph_json()).encode())
                elif url.path == "/cmd":
                    q = parse_qs(url.query)
                    op = q.get("op", [""])[0]
                    out = state.cmd(op, q)
                    self._send(200, "application/json", json.dumps(out).encode())
                else:
                    self._send(404, "text/plain", b"not found")
            except BrokenPipeError:
                pass

    return ThreadingHTTPServer(("127.0.0.1", port), Handler)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Live render viewer (browser-based).")
    p.add_argument("scene", help="path to the .rtvs scene file")
    p.add_argument("--port", type=int, default=8173)
    p.add_argument("-W", "--width", type=int, default=1280)
    p.add_argument("-H", "--height", type=int, default=720)
    p.add_argument("--spp", type=int, default=None)
    p.add_argument("--bounces", type=int, default=None)
    p.add_argument("--caustics", action="store_true")
    p.add_argument("--cpu", action="store_true",
                   help="the plain PyTorch pipeline on the CPU (default: the card)")
    args = p.parse_args(argv)

    overrides = {}
    if args.spp is not None:
        overrides["samples_per_pixel"] = args.spp
    if args.bounces is not None:
        overrides["max_bounces"] = args.bounces
    if args.caustics:
        overrides["enable_caustics"] = True

    state = ViewerState(args.scene, args.width, args.height, overrides,
                        device="cpu" if args.cpu else "cuda")
    server = make_server(state, args.port)
    print(f"viewer: http://127.0.0.1:{args.port}/  (ctrl-c to quit)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        state.loop.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
