"""The port's node graph (scene/graph.py, scene/nodes.py, models/) against
raytracevs_tpu's: the cases of tests/test_graph.py, each run by both
packages, their results equal (and equal to the values test_graph.py
expects). Topological order, incremental evaluation with the result cache,
dirty propagation, cycle tolerance, rewiring, the math nodes' polymorphism
and copy/paste."""
import types

import numpy as np
import pytest

import raytracevs_tpu.models as JM
import raytracevs_tpu.scene.graph as JG
import raytracevs_tpu.scene.rtvs as JR
import raytracevs_tpu.scene.transform as JT
import raytracevs_tpu_torch.models as PM
import raytracevs_tpu_torch.scene.graph as PG
import raytracevs_tpu_torch.scene.rtvs as PR
import raytracevs_tpu_torch.scene.transform as PT

JAX = types.SimpleNamespace(M=JM, G=JG, R=JR, T=JT)
PORT = types.SimpleNamespace(M=PM, G=PG, R=PR, T=PT)


def _wire(graph, a, out_name, b, in_name):
    return graph.connect(a.find_output(out_name), b.find_input(in_name))


def add_floats(p):
    g = p.G.NodeGraph()
    a = g.add_node(p.M.FloatNode(2.0))
    b = g.add_node(p.M.FloatNode(3.0))
    add = g.add_node(p.M.AddNode())
    _wire(g, a, "Value", add, "A")
    _wire(g, b, "Value", add, "B")
    return g.evaluate()[add.id]


def vector_math_polymorphism(p):
    v1, v2 = np.array([1.0, 2.0, 3.0]), np.array([4.0, 5.0, 6.0])
    out = []
    for node in (p.M.AddNode(), p.M.SubNode(), p.M.MulNode(), p.M.DivNode()):
        iv = {node.find_input("A").id: v1, node.find_input("B").id: v2}
        out.append(node.evaluate(iv).tolist())
    mul = p.M.MulNode()
    out.append(mul.evaluate({mul.find_input("A").id: v1, mul.find_input("B").id: 2.0}).tolist())
    return out


def div_by_zero_returns_numerator(p):
    g = p.G.NodeGraph()
    a = g.add_node(p.M.FloatNode(7.0))
    b = g.add_node(p.M.FloatNode(0.0))
    div = g.add_node(p.M.DivNode())
    _wire(g, a, "Value", div, "A")
    _wire(g, b, "Value", div, "B")
    return g.evaluate()[div.id]


def incremental_evaluation_uses_cache(p, monkeypatch):
    g = p.G.NodeGraph()
    a = g.add_node(p.M.FloatNode(2.0))
    add = g.add_node(p.M.AddNode())
    _wire(g, a, "Value", add, "A")
    g.evaluate()
    clean = not add.is_dirty
    calls = {"n": 0}
    orig = p.M.AddNode.evaluate

    def spy(self, iv):
        calls["n"] += 1
        return orig(self, iv)

    monkeypatch.setattr(p.M.AddNode, "evaluate", spy)
    g.evaluate()  # nothing dirty: no evaluation
    first = calls["n"]
    a.value = 10.0
    a.mark_dirty()
    dirty = add.is_dirty
    r = g.evaluate()
    return clean, first, dirty, calls["n"], r[add.id]


def dirty_propagation_is_transitive(p):
    g = p.G.NodeGraph()
    a = g.add_node(p.M.FloatNode(1.0))
    m1 = g.add_node(p.M.MulNode())
    m2 = g.add_node(p.M.MulNode())
    _wire(g, a, "Value", m1, "A")
    _wire(g, m1, "Result", m2, "A")
    g.evaluate()
    before = (m1.is_dirty, m2.is_dirty)
    a.mark_dirty()
    return before, (m1.is_dirty, m2.is_dirty)


def topological_order_respects_dependencies(p):
    g = p.G.NodeGraph()
    add = g.add_node(p.M.AddNode())  # added first but depends on the floats
    a = g.add_node(p.M.FloatNode(1.0))
    b = g.add_node(p.M.FloatNode(2.0))
    _wire(g, a, "Value", add, "A")
    _wire(g, b, "Value", add, "B")
    names = {id(add): "add", id(a): "a", id(b): "b"}
    return [names[id(n)] for n in g.topological_order()]


def cycle_tolerance(p):
    g = p.G.NodeGraph()
    m1 = g.add_node(p.M.AddNode())
    m2 = g.add_node(p.M.AddNode())
    _wire(g, m1, "Result", m2, "A")
    _wire(g, m2, "Result", m1, "A")
    order = g.topological_order()
    res = g.evaluate()  # must not raise
    return len(order), [res[n.id] for n in (m1, m2)]


def socket_compatibility(p):
    S = p.G.SocketType
    return [p.G.sockets_compatible(a, b) for a in S for b in S]


def input_rewire_replaces_connection(p):
    g = p.G.NodeGraph()
    a = g.add_node(p.M.FloatNode(1.0))
    b = g.add_node(p.M.FloatNode(2.0))
    add = g.add_node(p.M.AddNode())
    _wire(g, a, "Value", add, "A")
    _wire(g, b, "Value", add, "A")  # the same input again
    return len(g.connections), g.evaluate()[add.id]


def sphere_radius_scale(p):
    g = p.G.NodeGraph()
    s = g.add_node(p.M.SphereNode())
    s.radius = 2.0
    s.object_transform = p.T.Transform(scale=np.array([1.0, 3.0, 2.0]))
    return g.evaluate()[s.id].radius


def copy_paste_nodes(p):
    g = p.G.NodeGraph()
    mat = p.M.MaterialBSDFNode()
    mat.transmission = 0.7
    sph = p.M.SphereNode()
    sph.radius = 2.5
    sph.position = (100.0, 50.0)
    g.add_node(mat)
    g.add_node(sph)
    g.connect(mat.find_output("Material"), sph.find_input("Material"))
    clip = p.R.copy_nodes(g, [mat, sph])
    new = p.R.paste_nodes(g, clip)
    new_sph = next(n for n in new if isinstance(n, p.M.SphereNode))
    new_mat = next(n for n in new if isinstance(n, p.M.MaterialBSDFNode))
    pasted = [c for c in g.connections if c.output_node is new_mat]
    return (len(new), len(g.nodes), len(g.connections), len({n.id for n in g.nodes}),
            new_sph.radius, new_sph.position, new_mat.transmission,
            len(pasted) == 1 and pasted[0].input_node is new_sph,
            p.R.copy_nodes(g, [sph])["Connections"])


CASES = {
    "add_floats": (add_floats, 5.0),
    "vector_math_polymorphism": (vector_math_polymorphism, [
        [5, 7, 9], [-3, -3, -3], [4, 10, 18], [0.25, 0.4, 0.5], [2, 4, 6]]),
    "div_by_zero_returns_numerator": (div_by_zero_returns_numerator, 7.0),
    "incremental_evaluation_uses_cache": (incremental_evaluation_uses_cache,
                                          (True, 0, True, 1, 10.0)),
    "dirty_propagation_is_transitive": (dirty_propagation_is_transitive,
                                        ((False, False), (True, True))),
    "topological_order_respects_dependencies": (topological_order_respects_dependencies,
                                                ["a", "b", "add"]),
    "cycle_tolerance": (cycle_tolerance, None),
    "socket_compatibility": (socket_compatibility, None),
    "input_rewire_replaces_connection": (input_rewire_replaces_connection, (1, 2.0)),
    "sphere_radius_scale": (sphere_radius_scale, 6.0),
    "copy_paste_nodes": (copy_paste_nodes, (2, 4, 2, 4, 2.5, (130.0, 80.0), 0.7, True, [])),
}


@pytest.mark.parametrize("name", list(CASES))
def test_graph_case_matches_jax(name, monkeypatch):
    fn, expected = CASES[name]
    args = (monkeypatch,) if name == "incremental_evaluation_uses_cache" else ()
    got, want = fn(PORT, *args), fn(JAX, *args)
    assert got == want
    if expected is not None:
        assert got == expected


def test_node_types_match_jax():
    """The same 22 node types under the same names and short aliases, each
    with the same sockets."""
    assert sorted(PM.NODE_TYPES) == sorted(JM.NODE_TYPES)
    for name, cls in PM.NODE_TYPES.items():
        a, b = cls(), JM.NODE_TYPES[name]()
        assert type(a).__name__ == type(b).__name__
        for side in ("input_sockets", "output_sockets"):
            assert ([(s.name, s.type.name) for s in getattr(a, side)]
                    == [(s.name, s.type.name) for s in getattr(b, side)])
    assert PM.create_node("NoSuchNode") is None
