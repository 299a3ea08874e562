"""Node-graph core: sockets, connections, topological & incremental evaluation.

Re-implements the behavior of the reference editor's scene-model layer
(src/RayTraceVS.WPF/Models/Node.cs:70-192, NodeSocket.cs:9-20,
NodeConnection.cs, NodeGraph.cs:375-611, Utils/DirtyTracker.cs:30-66) as a
plain-Python dataclass graph: Kahn topological sort tolerant of cycles,
dirty-only incremental re-evaluation with per-node result caching, and BFS
downstream dirty propagation.

Copied from raytracevs_tpu/scene/graph.py (stdlib and numpy only).
"""
from __future__ import annotations

import enum
import itertools
import uuid
from collections import deque
from typing import Any, Callable, Dict, List, Optional


class SocketType(enum.Enum):
    """Socket value types (NodeSocket.cs:9-20)."""

    OBJECT = "Object"
    VECTOR3 = "Vector3"
    FLOAT = "Float"
    COLOR = "Color"
    MATERIAL = "Material"
    CAMERA = "Camera"
    LIGHT = "Light"
    SCENE = "Scene"
    TRANSFORM = "Transform"


def sockets_compatible(out_type: SocketType, in_type: SocketType) -> bool:
    """Connection type compatibility (ConnectionHandler.cs:342-354).

    Same type always connects; Color and Vector3 are mutually convertible.
    """
    if out_type == in_type:
        return True
    pair = {out_type, in_type}
    return pair == {SocketType.COLOR, SocketType.VECTOR3}


class NodeSocket:
    __slots__ = ("id", "name", "type", "is_input", "node")

    def __init__(self, name: str, type_: SocketType, is_input: bool, node: "Node"):
        self.id = uuid.uuid4()
        self.name = name
        self.type = type_
        self.is_input = is_input
        self.node = node

    def __repr__(self):
        return f"NodeSocket({self.name}, {self.type.value}, {'in' if self.is_input else 'out'})"


class NodeConnection:
    __slots__ = ("id", "output_socket", "input_socket")

    def __init__(self, output_socket: NodeSocket, input_socket: NodeSocket):
        self.id = uuid.uuid4()
        self.output_socket = output_socket
        self.input_socket = input_socket

    @property
    def output_node(self) -> "Node":
        return self.output_socket.node

    @property
    def input_node(self) -> "Node":
        return self.input_socket.node


class Node:
    """Observable node base with dirty flag and cached result (Node.cs:70-192)."""

    type_name = "Node"
    category = "Generic"

    def __init__(self, title: str = ""):
        self.id = uuid.uuid4()
        self.title = title or self.type_name
        self.position = (0.0, 0.0)
        self.input_sockets: List[NodeSocket] = []
        self.output_sockets: List[NodeSocket] = []
        self.is_dirty = True
        self.cached_result: Any = None
        self.graph: Optional["NodeGraph"] = None

    # --- socket helpers -------------------------------------------------
    def add_input(self, name: str, type_: SocketType) -> NodeSocket:
        s = NodeSocket(name, type_, True, self)
        self.input_sockets.append(s)
        return s

    def add_output(self, name: str, type_: SocketType) -> NodeSocket:
        s = NodeSocket(name, type_, False, self)
        self.output_sockets.append(s)
        return s

    def find_input(self, name: str) -> Optional[NodeSocket]:
        for s in self.input_sockets:
            if s.name == name:
                return s
        return None

    def find_output(self, name: str) -> Optional[NodeSocket]:
        for s in self.output_sockets:
            if s.name == name:
                return s
        return None

    def get_input_value(self, name: str, input_values: Dict[uuid.UUID, Any], default=None):
        s = self.find_input(name)
        if s is None:
            return default
        v = input_values.get(s.id)
        return default if v is None else v

    # --- dirty tracking -------------------------------------------------
    def mark_dirty(self) -> None:
        self.is_dirty = True
        if self.graph is not None:
            self.graph.propagate_dirty(self)

    def set_property(self, attr: str, value) -> bool:
        """Set an attribute; mark dirty on change. Mirrors SetProperty+MarkDirty."""
        old = getattr(self, attr, None)
        changed = not _values_equal(old, value)
        if changed:
            setattr(self, attr, value)
            self.mark_dirty()
        return changed

    # --- evaluation -----------------------------------------------------
    def evaluate(self, input_values: Dict[uuid.UUID, Any]) -> Any:
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}({self.title})"


def _values_equal(a, b) -> bool:
    try:
        import numpy as np

        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            return bool(np.array_equal(np.asarray(a), np.asarray(b)))
    except Exception:
        pass
    try:
        return bool(a == b)
    except Exception:
        return a is b


class NodeGraph:
    """Adjacency-list node graph with incremental evaluation (NodeGraph.cs:375-611)."""

    def __init__(self):
        self.nodes: List[Node] = []
        self.connections: List[NodeConnection] = []
        self._scene_changed_callbacks: List[Callable[[], None]] = []

    # --- structure ------------------------------------------------------
    def add_node(self, node: Node) -> Node:
        node.graph = self
        self.nodes.append(node)
        node.mark_dirty()
        self._notify()
        return node

    def remove_node(self, node: Node) -> None:
        downstream = [c.input_node for c in self.connections if c.output_node is node]
        self.connections = [
            c for c in self.connections if c.output_node is not node and c.input_node is not node
        ]
        self.nodes.remove(node)
        node.graph = None
        for n in downstream:
            n.mark_dirty()
        self._notify()

    def connect(self, output_socket: NodeSocket, input_socket: NodeSocket) -> NodeConnection:
        if output_socket.is_input or not input_socket.is_input:
            raise ValueError("connect() requires (output socket, input socket)")
        if not sockets_compatible(output_socket.type, input_socket.type):
            raise ValueError(
                f"incompatible socket types {output_socket.type} -> {input_socket.type}"
            )
        # An input socket holds at most one connection; rewiring replaces it
        # (ConnectionHandler.cs:272-302).
        self.connections = [c for c in self.connections if c.input_socket is not input_socket]
        conn = NodeConnection(output_socket, input_socket)
        self.connections.append(conn)
        input_socket.node.mark_dirty()
        self._notify()
        return conn

    def disconnect(self, connection: NodeConnection) -> None:
        self.connections.remove(connection)
        connection.input_node.mark_dirty()
        self._notify()

    def connection_into(self, input_socket: NodeSocket) -> Optional[NodeConnection]:
        for c in self.connections:
            if c.input_socket is input_socket:
                return c
        return None

    # --- scene-changed event (NodeGraph.cs:41-56) ------------------------
    def on_scene_changed(self, callback: Callable[[], None]) -> None:
        self._scene_changed_callbacks.append(callback)

    def _notify(self) -> None:
        for cb in self._scene_changed_callbacks:
            cb()

    # --- dirty propagation (DirtyTracker.cs:30-66) ------------------------
    def propagate_dirty(self, start: Node) -> None:
        """Non-recursive BFS downstream dirty propagation with dedup."""
        out_edges: Dict[int, List[Node]] = {}
        for c in self.connections:
            out_edges.setdefault(id(c.output_node), []).append(c.input_node)
        visited = {id(start)}
        queue = deque([start])
        while queue:
            node = queue.popleft()
            for nxt in out_edges.get(id(node), ()):  # downstream nodes
                if id(nxt) not in visited:
                    visited.add(id(nxt))
                    nxt.is_dirty = True
                    queue.append(nxt)

    # --- topological order (NodeGraph.cs:375-445) -------------------------
    def topological_order(self) -> List[Node]:
        """Kahn's algorithm; cycle members are appended at the end (cycle-tolerant)."""
        indegree = {id(n): 0 for n in self.nodes}
        out_edges: Dict[int, List[Node]] = {id(n): [] for n in self.nodes}
        for c in self.connections:
            if id(c.output_node) in out_edges and id(c.input_node) in indegree:
                out_edges[id(c.output_node)].append(c.input_node)
                indegree[id(c.input_node)] += 1
        queue = deque(n for n in self.nodes if indegree[id(n)] == 0)
        ordered: List[Node] = []
        while queue:
            n = queue.popleft()
            ordered.append(n)
            for nxt in out_edges[id(n)]:
                indegree[id(nxt)] -= 1
                if indegree[id(nxt)] == 0:
                    queue.append(nxt)
        if len(ordered) < len(self.nodes):  # cycle tolerance
            seen = {id(n) for n in ordered}
            ordered.extend(n for n in self.nodes if id(n) not in seen)
        return ordered

    # --- evaluation (NodeGraph.cs:518-611) --------------------------------
    def evaluate(self) -> Dict[uuid.UUID, Any]:
        """Evaluate dirty nodes in topological order; clean nodes serve cache.

        Returns {node.id: result}.
        """
        results: Dict[uuid.UUID, Any] = {}
        in_conn: Dict[uuid.UUID, NodeConnection] = {
            c.input_socket.id: c for c in self.connections
        }
        for node in self.topological_order():
            if not node.is_dirty and node.cached_result is not None:
                results[node.id] = node.cached_result
                continue
            input_values: Dict[uuid.UUID, Any] = {}
            for s in node.input_sockets:
                c = in_conn.get(s.id)
                if c is None:
                    continue
                upstream = results.get(c.output_node.id, c.output_node.cached_result)
                input_values[s.id] = _select_output(upstream, c.output_socket)
            try:
                result = node.evaluate(input_values)
            except Exception:
                result = None
            node.cached_result = result
            node.is_dirty = False
            results[node.id] = result
        return results


def _select_output(result: Any, output_socket: NodeSocket) -> Any:
    """Pick the per-socket value for multi-output nodes.

    Nodes with a single output return the value directly; nodes with several
    outputs may return a dict keyed by socket name.
    """
    if isinstance(result, dict) and output_socket.name in result:
        return result[output_socket.name]
    return result


_counter = itertools.count()
