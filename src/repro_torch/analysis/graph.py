"""Project-wide function index and heuristic call graph (the port's copy of
the JAX package's ``analysis/graph.py``).

Both cross-module analyses — ``no-ordered-callback-in-tp`` reachability and
thread-role propagation — need the same thing: every function/method (with
nested closures qualified as ``Outer.<locals>.inner``), its calls, its
``self.X`` accesses, and which lock (if any) each access happens under.

Resolution is deliberately heuristic and *over-approximate*:

* ``self.m(...)`` resolves to ``Class.m`` of the enclosing class when it
  exists, else to every indexed method named ``m``;
* ``obj.m(...)`` resolves to every indexed method named ``m`` (minus a
  stoplist of container/stdlib names that would wire the graph to noise);
* ``f(...)`` resolves to a sibling nested def, a module-level function in
  the same module, or a globally unique function of that name.

Over-approximation is safe for both clients: extra reachability can only
make the TP rule and the role audit *stricter*.  Names on the stoplist
include thread-handoff entry points (``submit``/``start``/``put``) on
purpose — work handed to another thread must NOT inherit the caller's
role; that is what explicit role seeds are for.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .lint import Module, unparse

__all__ = ["FuncInfo", "Access", "FunctionIndex", "CALL_STOPLIST"]

# Method names never resolved through the call graph.  Two flavours:
# container/stdlib noise (append/get/...) and cross-thread handoffs
# (submit/start/put) whose callee runs under a *different* role.
CALL_STOPLIST = frozenset({
    # containers / builtins
    "append", "extend", "pop", "add", "update", "get", "items", "keys",
    "values", "setdefault", "remove", "discard", "clear", "sort", "insert",
    "index", "count", "copy", "popleft", "appendleft",
    # strings / formatting
    "format", "split", "strip", "startswith", "endswith", "encode",
    "decode", "lower", "upper", "replace",
    # thread handoffs — role boundaries, seeded explicitly
    "submit", "start", "put", "put_nowait", "map",
    # concurrency primitives (stdlib objects, not repo code)
    "set", "is_set", "acquire", "release", "result", "cancel_futures",
})

_MUTATORS = frozenset({
    "append", "extend", "pop", "add", "update", "remove", "discard",
    "clear", "insert", "setdefault", "put", "put_nowait", "popleft",
    "appendleft", "sort",
})

_LOCK_NAME = re.compile(r"lock", re.IGNORECASE)

# `# repro-role: role-a, role-b [-- note]` trailing a `def` line seeds those
# roles on that function (in addition to the central map in roles.py).
_ROLE_COMMENT = re.compile(r"#\s*repro-role:\s*([a-z\-]+(?:\s*,\s*[a-z\-]+)*)")


@dataclass
class Access:
    """One ``self.X`` touch inside a function."""
    attr: str
    line: int
    is_write: bool
    lock: Optional[str]     # normalized lock id held at the access, if any


@dataclass
class FuncInfo:
    qualname: str           # "core/engine.py::NeoEngine.step" (+ .<locals>.)
    shortname: str          # "NeoEngine.step" / "NeoEngine.f.<locals>.g"
    module: Module
    node: ast.AST
    classname: Optional[str]
    calls: List[ast.Call] = field(default_factory=list)
    accesses: List[Access] = field(default_factory=list)
    role_comments: Tuple[str, ...] = ()
    # lock-order: edges (outer_lock, inner_lock, line) from nested withs,
    # plus locks acquired at this function's own top level.
    lock_edges: List[Tuple[str, str, int]] = field(default_factory=list)
    acquired_locks: List[Tuple[str, int]] = field(default_factory=list)
    calls_under_lock: List[Tuple[str, ast.Call]] = field(default_factory=list)


def _is_lock_expr(expr: ast.expr) -> Optional[str]:
    """A `with` context manager that looks like a lock: the final attribute
    (or name) contains 'lock'.  Returns a normalized id or None."""
    target = expr
    if isinstance(target, ast.Call):
        return None  # e.g. tracer.span(...) / open(...)
    name = None
    if isinstance(target, ast.Attribute):
        name = target.attr
    elif isinstance(target, ast.Name):
        name = target.id
    if name is not None and _LOCK_NAME.search(name):
        return unparse(target)
    return None


def _normalize_lock(lock_expr: str, classname: Optional[str]) -> str:
    if lock_expr.startswith("self.") and classname:
        return f"{classname}.{lock_expr[5:]}"
    return lock_expr


class _FuncVisitor(ast.NodeVisitor):
    """Walks one function body (stopping at nested defs, which become their
    own FuncInfo), recording calls, self-attribute accesses and the lock
    stack active at each point."""

    def __init__(self, info: FuncInfo) -> None:
        self.info = info
        self.lock_stack: List[str] = []

    # -- nested defs are separate functions -------------------------------
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        if node is not self.info.node:
            return  # handled as its own FuncInfo
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    def visit_Lambda(self, node: ast.Lambda) -> None:
        self.generic_visit(node)  # lambdas stay part of the enclosing fn

    # -- locks --------------------------------------------------------------
    def visit_With(self, node: ast.With) -> None:
        locks: List[str] = []
        for item in node.items:
            lock = _is_lock_expr(item.context_expr)
            if lock is not None:
                lock = _normalize_lock(lock, self.info.classname)
                if self.lock_stack:
                    self.info.lock_edges.append(
                        (self.lock_stack[-1], lock, node.lineno))
                else:
                    self.info.acquired_locks.append((lock, node.lineno))
                locks.append(lock)
            else:
                item.context_expr and self.visit(item.context_expr)
        for item in node.items:
            if item.optional_vars is not None:
                self.visit(item.optional_vars)
        self.lock_stack.extend(locks)
        for stmt in node.body:
            self.visit(stmt)
        for _ in locks:
            self.lock_stack.pop()

    # -- calls --------------------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        self.info.calls.append(node)
        if self.lock_stack:
            self.info.calls_under_lock.append((self.lock_stack[-1], node))
        # mutation-through-method counts as a write: self.X.append(...)
        f = node.func
        if (
            isinstance(f, ast.Attribute)
            and f.attr in _MUTATORS
            and isinstance(f.value, ast.Attribute)
            and isinstance(f.value.value, ast.Name)
            and f.value.value.id == "self"
        ):
            self._record(f.value.attr, node.lineno, is_write=True)
        self.generic_visit(node)

    # -- self.X accesses ----------------------------------------------------
    def visit_Attribute(self, node: ast.Attribute) -> None:
        if isinstance(node.value, ast.Name) and node.value.id == "self":
            is_write = isinstance(node.ctx, (ast.Store, ast.Del))
            self._record(node.attr, node.lineno, is_write=is_write)
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript) -> None:
        # self.X[i] = v  /  del self.X[i]  mutate the container behind X
        if (
            isinstance(node.ctx, (ast.Store, ast.Del))
            and isinstance(node.value, ast.Attribute)
            and isinstance(node.value.value, ast.Name)
            and node.value.value.id == "self"
        ):
            self._record(node.value.attr, node.lineno, is_write=True)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        t = node.target
        if (
            isinstance(t, ast.Attribute)
            and isinstance(t.value, ast.Name)
            and t.value.id == "self"
        ):
            self._record(t.attr, node.lineno, is_write=True)
            self._record(t.attr, node.lineno, is_write=False)
        self.generic_visit(node)

    def _record(self, attr: str, line: int, is_write: bool) -> None:
        lock = self.lock_stack[-1] if self.lock_stack else None
        self.info.accesses.append(Access(attr, line, is_write, lock))


class FunctionIndex:
    """Every function in a module set, with heuristic call resolution."""

    def __init__(self, modules: Sequence[Module]) -> None:
        self.functions: Dict[str, FuncInfo] = {}
        self.by_method: Dict[str, List[str]] = {}
        self.by_plain: Dict[str, List[str]] = {}
        self.node_to_qual: Dict[int, str] = {}
        for m in modules:
            self._index_module(m)
        for info in self.functions.values():
            visitor = _FuncVisitor(info)
            visitor.visit(info.node)

    # -- indexing -----------------------------------------------------------

    def _index_module(self, module: Module) -> None:
        def visit(node: ast.AST, prefix: str, classname: Optional[str]) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    visit(child, child.name, child.name)
                elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    short = f"{prefix}.{child.name}" if prefix else child.name
                    qual = f"{module.relpath}::{short}"
                    roles = _roles_from_comment(module, child)
                    info = FuncInfo(qual, short, module, child, classname,
                                    role_comments=roles)
                    self.functions[qual] = info
                    self.node_to_qual[id(child)] = qual
                    if classname is not None and "<locals>" not in short:
                        self.by_method.setdefault(child.name, []).append(qual)
                    if prefix == "":
                        self.by_plain.setdefault(child.name, []).append(qual)
                    visit(child, f"{short}.<locals>", classname)
                else:
                    visit(child, prefix, classname)

        visit(module.tree, "", None)

    # -- resolution ---------------------------------------------------------

    def resolve_call(self, call: ast.Call, caller: FuncInfo) -> List[str]:
        f = call.func
        out: List[str] = []
        if isinstance(f, ast.Name):
            # sibling nested def first
            nested = f"{caller.qualname}.<locals>.{f.id}"
            if nested in self.functions:
                return [nested]
            # a nested def of an enclosing function
            base = caller.qualname
            while ".<locals>." in base:
                base = base.rsplit(".<locals>.", 1)[0]
                cand = f"{base}.<locals>.{f.id}"
                if cand in self.functions:
                    return [cand]
            local = f"{caller.module.relpath}::{f.id}"
            if local in self.functions:
                return [local]
            for qual in self.by_plain.get(f.id, ()):
                out.append(qual)
            return out
        if isinstance(f, ast.Attribute):
            if f.attr in CALL_STOPLIST:
                return []
            if isinstance(f.value, ast.Name) and f.value.id == "self":
                if caller.classname is not None:
                    own = self._class_method(caller, f.attr)
                    if own is not None:
                        return [own]
            return list(self.by_method.get(f.attr, ()))
        return []

    def _class_method(self, caller: FuncInfo, name: str) -> Optional[str]:
        short = f"{caller.classname}.{name}"
        qual = f"{caller.module.relpath}::{short}"
        return qual if qual in self.functions else None

    def qual_of_node(self, node: ast.AST) -> Optional[str]:
        return self.node_to_qual.get(id(node))

    def by_shortname(self, pattern: str) -> List[str]:
        """Match ``shortname`` exactly, or by glob when the pattern ends in
        ``.*`` (direct members only — ``Class.*`` does not match nested
        ``Class.m.<locals>.f``) or ``.<locals>.*`` (nested defs)."""
        out = []
        if pattern.endswith(".<locals>.*"):
            prefix = pattern[: -len("*")]
            for qual, info in self.functions.items():
                if info.shortname.startswith(prefix):
                    out.append(qual)
        elif pattern.endswith(".*"):
            prefix = pattern[:-1]
            for qual, info in self.functions.items():
                short = info.shortname
                if short.startswith(prefix) and "<locals>" not in short[len(prefix):]:
                    out.append(qual)
        else:
            for qual, info in self.functions.items():
                if info.shortname == pattern:
                    out.append(qual)
        return out


def _roles_from_comment(module: Module, node: ast.AST) -> Tuple[str, ...]:
    line = getattr(node, "lineno", None)
    if line is None:
        return ()
    # decorators shift lineno; scan def line and the line above it
    for cand in (line, line - 1):
        if 1 <= cand <= len(module.lines):
            m = _ROLE_COMMENT.search(module.lines[cand - 1])
            if m is not None:
                return tuple(r.strip() for r in m.group(1).split(",") if r.strip())
    return ()
