"""Editing command system: undo/redo over the node graph.

Headless re-implementation of the reference editor's command pattern
(src/RayTraceVS.WPF/Commands/CommandManager.cs:39-100 — 100-deep undo stack
with `RegisterExecuted` for UI-applied operations; NodeCommands.cs,
ConnectionCommands.cs, PropertyCommands.cs). The C# editor's interactive
handlers map to this programmatic API.

Copied from raytracevs_tpu/scene/commands.py (stdlib only).
"""
from __future__ import annotations

from typing import Any, List, Optional

from .graph import Node, NodeConnection, NodeGraph, NodeSocket, sockets_compatible


class EditorCommand:
    """IEditorCommand analog."""

    description = "command"

    def execute(self) -> None:
        raise NotImplementedError

    def undo(self) -> None:
        raise NotImplementedError


class AddNodeCommand(EditorCommand):
    def __init__(self, graph: NodeGraph, node: Node):
        self.graph = graph
        self.node = node
        self.description = f"add {node.title}"
        self._connections: List[NodeConnection] = []

    def execute(self) -> None:
        self.graph.add_node(self.node)
        for c in self._connections:  # redo restores edges removed by undo
            self.graph.connect(c.output_socket, c.input_socket)

    def undo(self) -> None:
        self._connections = [
            c for c in self.graph.connections
            if c.output_node is self.node or c.input_node is self.node
        ]
        self.graph.remove_node(self.node)


class RemoveNodeCommand(EditorCommand):
    def __init__(self, graph: NodeGraph, node: Node):
        self.graph = graph
        self.node = node
        self.description = f"remove {node.title}"
        self._connections: List[NodeConnection] = []

    def execute(self) -> None:
        self._connections = [
            c for c in self.graph.connections
            if c.output_node is self.node or c.input_node is self.node
        ]
        self.graph.remove_node(self.node)

    def undo(self) -> None:
        self.graph.add_node(self.node)
        for c in self._connections:
            self.graph.connect(c.output_socket, c.input_socket)


class ConnectCommand(EditorCommand):
    """Drag-to-connect with rewiring semantics (ConnectionHandler.cs:272-354)."""

    def __init__(self, graph: NodeGraph, output_socket: NodeSocket, input_socket: NodeSocket):
        if not sockets_compatible(output_socket.type, input_socket.type):
            raise ValueError("incompatible sockets")
        self.graph = graph
        self.output_socket = output_socket
        self.input_socket = input_socket
        self.description = f"connect {output_socket.name} -> {input_socket.name}"
        self._replaced: Optional[NodeConnection] = None
        self._created: Optional[NodeConnection] = None

    def execute(self) -> None:
        self._replaced = self.graph.connection_into(self.input_socket)
        self._created = self.graph.connect(self.output_socket, self.input_socket)

    def undo(self) -> None:
        if self._created is not None:
            self.graph.disconnect(self._created)
        if self._replaced is not None:
            self.graph.connect(self._replaced.output_socket, self._replaced.input_socket)


class DisconnectCommand(EditorCommand):
    def __init__(self, graph: NodeGraph, connection: NodeConnection):
        self.graph = graph
        self.connection = connection
        self.description = "disconnect"

    def execute(self) -> None:
        self.graph.disconnect(self.connection)

    def undo(self) -> None:
        self.graph.connect(self.connection.output_socket, self.connection.input_socket)


class SetPropertyCommand(EditorCommand):
    """PropertyCommands analog: undoable node attribute change."""

    def __init__(self, node: Node, attr: str, value: Any):
        self.node = node
        self.attr = attr
        self.value = value
        self.description = f"set {attr}"
        self._old: Any = None

    def execute(self) -> None:
        self._old = getattr(self.node, self.attr)
        self.node.set_property(self.attr, self.value)

    def undo(self) -> None:
        self.node.set_property(self.attr, self._old)


class ApplyPropertiesCommand(EditorCommand):
    """Undoable .rtvs-shaped property edit — the property-panel analog.

    Takes properties in the same JSON shape the .rtvs file uses
    (SceneFileService.cs:308-560), so the viewer's editor speaks the
    serialization contract rather than raw Python attributes. Undo restores
    the node's full serialized snapshot."""

    def __init__(self, node: Node, props: dict):
        self.node = node
        self.props = dict(props)
        self.description = f"edit {node.title}"
        self._old: dict = None

    def execute(self) -> None:
        from .rtvs import _apply_properties, _serialize_properties

        if self._old is None:
            self._old = _serialize_properties(self.node)
        try:
            _apply_properties(self.node, self.props)
        except Exception:
            # A bad property value must not leave the node half-edited:
            # CommandManager only registers commands whose execute()
            # succeeded, so restore the snapshot before re-raising.
            _apply_properties(self.node, self._old)
            raise
        self.node.mark_dirty()

    def undo(self) -> None:
        from .rtvs import _apply_properties

        _apply_properties(self.node, self._old)
        self.node.mark_dirty()


class MoveNodesCommand(EditorCommand):
    """Canvas node-drag analog (Views/Handlers/NodeDragHandler.cs:119-219):
    one undo entry per completed drag, covering every selected node."""

    def __init__(self, moves):
        # moves: iterable of (node, (x, y)) final positions
        self.moves = [(n, (float(p[0]), float(p[1]))) for n, p in moves]
        self._old = [(n, tuple(n.position)) for n, _ in self.moves]
        self.description = f"move {len(self.moves)} node(s)"

    def execute(self) -> None:
        for n, p in self.moves:
            n.position = p

    def undo(self) -> None:
        for n, p in self._old:
            n.position = p


class PasteCommand(EditorCommand):
    """Clipboard paste as one undo entry (NodeEditorView.xaml.cs:806-900
    HandlePaste). Redo re-instantiates with fresh ids, like the editor."""

    def __init__(self, graph, clipboard: dict, offset=(30.0, 30.0)):
        self.graph = graph
        self.clipboard = clipboard
        self.offset = offset
        self.description = f"paste {len(clipboard.get('Nodes', []))} node(s)"
        self._nodes = []

    def execute(self) -> None:
        from .rtvs import paste_nodes

        self._nodes = paste_nodes(self.graph, self.clipboard, self.offset)

    def undo(self) -> None:
        for n in self._nodes:
            self.graph.remove_node(n)
        self._nodes = []


class CompositeCommand(EditorCommand):
    """CompositeCommand.cs analog: group of commands as one undo step."""

    def __init__(self, commands: List[EditorCommand], description: str = "composite"):
        self.commands = list(commands)
        self.description = description

    def execute(self) -> None:
        for c in self.commands:
            c.execute()

    def undo(self) -> None:
        for c in reversed(self.commands):
            c.undo()


class CommandManager:
    """Undo/redo stacks, 100 deep (CommandManager.cs:39-100)."""

    MAX_DEPTH = 100

    def __init__(self):
        self._undo: List[EditorCommand] = []
        self._redo: List[EditorCommand] = []

    def execute(self, command: EditorCommand) -> None:
        command.execute()
        self.register_executed(command)

    def register_executed(self, command: EditorCommand) -> None:
        """Record an already-applied operation (RegisterExecuted)."""
        self._undo.append(command)
        if len(self._undo) > self.MAX_DEPTH:
            self._undo.pop(0)
        self._redo.clear()

    @property
    def can_undo(self) -> bool:
        return bool(self._undo)

    @property
    def can_redo(self) -> bool:
        return bool(self._redo)

    def undo(self) -> bool:
        if not self._undo:
            return False
        c = self._undo.pop()
        c.undo()
        self._redo.append(c)
        return True

    def redo(self) -> bool:
        if not self._redo:
            return False
        c = self._redo.pop()
        c.execute()
        self._undo.append(c)
        return True
