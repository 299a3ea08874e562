"""The port's live viewer (api/viewer.py) with scene/commands.py and
io/settings.py against the JAX package's, on the CPU.

The command stacks: one sequence of commands, undos and redos on the demo
scene's graph (_torch_scenes.scene_graph) in both packages, the graphs
serialised after every step and equal. The settings: written by one
package, read by the other (HOME in a temporary directory). The viewer: the
port's ViewerState(device="cpu") serves the demo scene's file at 32x16,
spp 1, 2 bounces; its endpoints answer, and its /graph and /cmd replies
equal those of a JAX ViewerState on the same file whose _start_engine loads
the graph only (no JAX frame renders). Replies are compared without the
keys that time or count the renders (fps, render_ms, frames, rays) and
without "backend", which names each package's engine. The port's render
loop stops at teardown."""
import json
import threading
import time
import types
import urllib.error
import urllib.request
from urllib.parse import urlencode

import pytest

import _torch_scenes as S
import raytracevs_tpu.io.settings as JS
import raytracevs_tpu.models as JM
import raytracevs_tpu.scene.commands as JC
import raytracevs_tpu.scene.graph as JG
import raytracevs_tpu.scene.rtvs as JR
from raytracevs_tpu.api import viewer as JV
from raytracevs_tpu.scene import data as JD
import raytracevs_tpu_torch.io.settings as PS
import raytracevs_tpu_torch.models as PM
import raytracevs_tpu_torch.scene.commands as PC
import raytracevs_tpu_torch.scene.graph as PG
import raytracevs_tpu_torch.scene.rtvs as PR
from raytracevs_tpu_torch.api import viewer as PV
from raytracevs_tpu_torch.io.png import read_png
from raytracevs_tpu_torch.scene import data as PD

S.one_torch_thread()

JAX = types.SimpleNamespace(M=JM, G=JG, C=JC, R=JR, D=JD)
PORT = types.SimpleNamespace(M=PM, G=PG, C=PC, R=PR, D=PD)
TIMED = ("fps", "render_ms", "frames", "rays", "backend")


def _canonical(graph, R):
    """The graph with node ids replaced by their index (pasted and added
    nodes get fresh random ids in each package)."""
    index = {n.id: i for i, n in enumerate(graph.nodes)}
    return dict(
        nodes=[(n.type_name, n.title, tuple(float(v) for v in n.position),
                json.dumps(R._serialize_properties(n), sort_keys=True, default=float))
               for n in graph.nodes],
        connections=[(index[c.output_node.id], c.output_socket.name, index[c.input_node.id],
                      c.input_socket.name) for c in graph.connections])


def _command_steps(p, graph):
    """The sequence, as (kind, factory) over the package `p`; each factory
    builds its command from the graph's current nodes by index."""
    nodes = graph.nodes

    def node_of(type_name, k=0):
        return [n for n in graph.nodes if n.type_name == type_name][k]

    def connect():
        out = node_of("MaterialBSDFNode", 1).find_output("Material")
        return p.C.ConnectCommand(graph, out, node_of("SphereNode").find_input("Material"))

    return [
        ("do", lambda: p.C.SetPropertyCommand(node_of("SphereNode"), "radius", 0.7)),
        ("do", lambda: p.C.ApplyPropertiesCommand(node_of("PointLightNode"),
                                                  {"Intensity": 3.5, "Radius": 0.2})),
        ("do", lambda: p.C.MoveNodesCommand([(nodes[0], (12.0, 34.0)), (nodes[2], (-5.0, 6.5))])),
        ("do", lambda: p.C.AddNodeCommand(graph, p.M.NODE_TYPES["SphereNode"]())),
        ("do", connect),
        ("undo", None),
        ("redo", None),
        ("do", lambda: p.C.DisconnectCommand(
            graph, graph.connection_into(node_of("SphereNode").find_input("Material")))),
        ("do", lambda: p.C.PasteCommand(graph, p.R.copy_nodes(graph, [node_of("SphereNode"),
                                                                       node_of("MaterialBSDFNode")]))),
        ("do", lambda: p.C.CompositeCommand([p.C.RemoveNodeCommand(graph, node_of("BoxNode")),
                                             p.C.RemoveNodeCommand(graph, node_of("PlaneNode"))])),
        ("undo", None), ("undo", None),
        ("redo", None), ("redo", None),
        ("do", lambda: p.C.RemoveNodeCommand(graph, node_of("CameraNode"))),
        ("undo", None),
    ]


def test_command_manager_matches_jax():
    """Each execute, undo and redo leaves both packages' graphs equal, with
    the same undo/redo availability."""
    runs = []
    for p in (JAX, PORT):
        graph = S.scene_graph(p.M, p.G, S.demo_scene(p.D))
        mgr = p.C.CommandManager()
        snaps = [_canonical(graph, p.R)]
        for kind, make in _command_steps(p, graph):
            if kind == "do":
                mgr.execute(make())
            else:
                assert getattr(mgr, kind)()
            snaps.append((_canonical(graph, p.R), mgr.can_undo, mgr.can_redo))
        runs.append(snaps)
    assert len(runs[0]) == len(runs[1]) == 17
    for j, q in zip(*runs):
        assert j == q
    assert runs[1][0] != runs[1][-1][0]  # the sequence changed the graph


def test_redo_of_an_undone_disconnect_raises_in_both():
    """The reference's DisconnectCommand reconnects on undo with a new
    connection object, so its redo cannot remove the one it holds: both
    packages raise the same ValueError (ROADMAP C12)."""
    for p in (JAX, PORT):
        graph = S.scene_graph(p.M, p.G, S.demo_scene(p.D))
        mgr = p.C.CommandManager()
        sphere = next(n for n in graph.nodes if n.type_name == "SphereNode")
        mgr.execute(p.C.DisconnectCommand(graph, graph.connection_into(
            sphere.find_input("Material"))))
        assert mgr.undo()
        with pytest.raises(ValueError, match="not in list"):
            mgr.redo()


def test_settings_round_trip_with_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    ps, js = PS.SettingsService(), JS.SettingsService()
    assert ps.path == js.path == str(tmp_path / ".raytracevs_tpu" / "settings.json")
    assert ps.load() == PS.AppSettings() and js.load() == JS.AppSettings()
    ps.settings.last_scene_file = "scene.rtvs"
    ps.settings.render_width, ps.settings.screenshot_folder = 1280, str(tmp_path / "shots")
    ps.save()
    got = js.load()
    assert {k: getattr(got, k) for k in JS.AppSettings.__dataclass_fields__} == \
        {k: getattr(ps.settings, k) for k in PS.AppSettings.__dataclass_fields__}
    text = open(ps.path).read()
    js.settings.left_panel_width = 250.0
    js.save()
    assert PS.SettingsService().load().left_panel_width == 250.0
    js.settings.left_panel_width = 200.0
    js.save()
    assert open(ps.path).read() == text  # the same file, byte for byte
    with open(ps.path, "w") as f:
        f.write("{not json")
    assert PS.SettingsService().load() == PS.AppSettings()


@pytest.fixture(scope="module")
def scene_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("viewer") / "demo.rtvs")
    PR.save_graph(S.scene_graph(PM, PG, S.demo_scene(PD)), path)
    return path


OVERRIDES = {"samples_per_pixel": 1, "max_bounces": 2}


@pytest.fixture(scope="module")
def viewer(scene_file):
    """The port's viewer on the CPU at 32x16, served on an ephemeral port."""
    saved = PV.RESOLUTIONS
    PV.RESOLUTIONS = [(32, 16), (48, 24)]  # a cheap resolution switch
    state = PV.ViewerState(scene_file, 32, 16, overrides=OVERRIDES, device="cpu")
    server = PV.make_server(state, port=0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    yield state, server.server_address[1]
    server.shutdown()
    server.server_close()
    state.loop.stop()
    PV.RESOLUTIONS = saved
    assert state.loop._thread is None


def _jax_state(scene_file, monkeypatch):
    """A JAX ViewerState on the same file whose engine only takes scenes."""
    def start(self, width, height):
        self.engine = types.SimpleNamespace(width=width, height=height, backend="jnp",
                                            last_rays=0, update_scene=lambda *a, **k: None)
        self.loop = types.SimpleNamespace(stop=lambda: None, start=lambda: None,
                                          request_frame=lambda: None)
        if self.graph is None:
            self.graph = JR.load_graph(self.scene_path)

    monkeypatch.setattr(JV.ViewerState, "_start_engine", start)
    monkeypatch.setattr(JV, "RESOLUTIONS", [(32, 16), (48, 24)])
    return JV.ViewerState(scene_file, 32, 16, overrides=OVERRIDES)


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _wait_frames(port, n, timeout=120.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        s = json.loads(_get(port, "/status")[1])
        if s["frames"] >= n:
            return s
        time.sleep(0.1)
    raise TimeoutError(f"fewer than {n} frames")


def _untimed(reply):
    return {k: v for k, v in reply.items() if k not in TIMED}


def test_viewer_endpoints(viewer, tmp_path):
    state, port = viewer
    code, page = _get(port, "/")
    assert code == 200 and page.decode() == JV._PAGE
    s = _wait_frames(port, 2)
    assert (s["width"], s["height"], s["backend"]) == (32, 16, "cpu")
    assert s["render_ms"] > 0 and s["rays"] > 0
    code, png = _get(port, "/frame.png")
    assert code == 200 and png[:8] == b"\x89PNG\r\n\x1a\n"
    path = tmp_path / "f.png"
    path.write_bytes(png)
    img = read_png(str(path))
    assert img.shape == (16, 32, 4) and img[..., :3].std() > 5
    assert _get(port, "/nothing")[0] == 404


def _node_ids(graph_json, type_name):
    return [n["id"] for n in graph_json["nodes"] if n["type"] == type_name]


def _graph_canonical(g):
    index = {n["id"]: i for i, n in enumerate(g["nodes"])}
    nodes = [{k: v for k, v in n.items() if k != "id"} for n in g["nodes"]]
    conns = [dict(c, out_node=index[c["out_node"]], in_node=index[c["in_node"]])
             for c in g["connections"]]
    return dict(g, nodes=nodes, connections=conns)


def test_viewer_graph_and_commands_match_jax(viewer, scene_file, monkeypatch):
    """/graph and every /cmd reply of a sequence equal the JAX viewer's:
    property edits, a move, an added node, connect/disconnect, copy/paste,
    a multi-delete, undo/redo, the error replies, the debug and photon
    modes, a reset and a resolution switch. A setprop and its undo change
    and restore the graph."""
    state, port = viewer
    jstate = _jax_state(scene_file, monkeypatch)

    def graphs():
        return json.loads(_get(port, "/graph")[1]), jstate.graph_json()

    pg, jg = graphs()
    assert pg == jg  # the same file: the same ids
    sphere = _node_ids(pg, "SphereNode")[0]
    props = next(n for n in pg["nodes"] if n["id"] == sphere)["properties"]
    edited = json.dumps(dict(props, Radius=0.42))

    def ids(side, kind, k=0):
        return _node_ids(graphs()[side], kind)[k]

    steps = [
        lambda s: dict(op="setprop", node=ids(s, "SphereNode"), props=edited),
        lambda s: dict(op="undo"),
        lambda s: dict(op="redo"),
        lambda s: dict(op="move", moves=json.dumps([dict(node=ids(s, "CameraNode"), x=5, y=7)])),
        lambda s: dict(op="addnode", type="SphereNode", x="10", y="20"),
        lambda s: dict(op="connect", out_node=ids(s, "MaterialBSDFNode", 1), out_sock="Material",
                       in_node=ids(s, "SphereNode", 1), in_sock="Material"),
        lambda s: dict(op="disconnect", in_node=ids(s, "SphereNode", 1), in_sock="Material"),
        lambda s: dict(op="copy", nodes=f"{ids(s, 'SphereNode')},{ids(s, 'MaterialBSDFNode')}"),
        lambda s: dict(op="paste"),
        lambda s: dict(op="delnodes", nodes=f"{ids(s, 'BoxNode')},{ids(s, 'PlaneNode')}"),
        lambda s: dict(op="undo"),
        lambda s: dict(op="delnode", node="not-a-uuid"),
        lambda s: dict(op="setprop", node=ids(s, "SphereNode"), props="[1, 2]"),
        lambda s: dict(op="debug", mode="3"),
        lambda s: dict(op="debug", mode="0"),
        lambda s: dict(op="photon"),
        lambda s: dict(op="reset"),
        lambda s: dict(op="res", dir="1"),
    ]
    replies, radius = [], []
    for make in steps:
        pa, ja = make(0), make(1)
        code, body = _get(port, "/cmd?" + urlencode(pa))
        assert code == 200
        got, want = json.loads(body), jstate.cmd(ja["op"], {k: [v] for k, v in ja.items()})
        assert _untimed(got) == _untimed(want), (pa["op"], got, want)
        pg, jg = graphs()
        assert _graph_canonical(pg) == _graph_canonical(jg), pa["op"]
        replies.append(got)
        radius.append(next(n for n in pg["nodes"] if n["id"] == sphere)["properties"]["Radius"])
    assert radius[:3] == [0.42, props["Radius"], 0.42]
    assert replies[7]["copied"] == 2
    assert "no node" not in json.dumps(replies[:11]) and "error" not in json.dumps(replies[:11])
    assert "bad node id" in replies[11]["error"] and "JSON object" in replies[12]["error"]
    s = _wait_frames(port, json.loads(_get(port, "/status")[1])["frames"] + 2)
    assert (s["width"], s["height"], s["photon_debug_mode"]) == (48, 24, 1)
    assert _get(port, "/frame.png")[0] == 200
