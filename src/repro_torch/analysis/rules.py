"""The five engine-invariant rules (the port's copy of the JAX package's
``analysis/rules.py``).

Each rule encodes one line of ROADMAP prose as an AST check:

``tracer-emit-guard``
    Tracing is optional (``attach_tracer``), so every
    ``tracer.emit/span/instant/counter/...`` call must be dominated by a
    ``None`` guard — otherwise the first un-traced serve crashes in a
    worker thread where the exception is easy to lose.
``no-ordered-callback-in-tp``
    ``io_callback(..., ordered=True)`` deadlocks/unsupported inside
    ``shard_map``; any function reachable from a ``with tp_body(...)``
    block must use ``ordered=False`` (or guard the ordered variant behind
    ``tp_axis() is None``).  The port has no ``io_callback`` (its host
    attention runs on the caller's thread or a pool of its own), so over
    ``repro_torch`` the rule is clean by construction; it stays for the
    reference profile, whose tree it guards.
``page-ownership``
    KV pages are refcounted by ``PagePool.alloc/incref/free``; touching a
    pool's ``_free`` list or ``_ref`` counts from outside ``kv_cache.py``
    forks the ownership protocol.
``span-clock``
    The span timeline and reconcile() share one clock domain —
    ``time.perf_counter``.  ``time.time`` anywhere in the package would
    mix wall-clock into monotonic math.
``no-wall-clock-in-plan``
    ``scheduler.py``/``perfmodel.py`` must stay pure functions of queue
    state: any ``time.*`` access there is a planning side effect (the two
    guarded tracer-timestamp sites carry justified allows).
"""

from __future__ import annotations

import ast
from typing import List, Optional, Sequence, Set

from .graph import FunctionIndex
from .lint import (
    Finding,
    Module,
    ProjectRule,
    Rule,
    dominating_facts,
    enclosing_function,
    local_aliases,
    unparse,
)

__all__ = [
    "TracerEmitGuard",
    "NoOrderedCallbackInTP",
    "PageOwnership",
    "SpanClock",
    "NoWallClockInPlan",
    "INVARIANT_RULES",
]

# every SpanTracer entry point that may be called on a possibly-None tracer
_EMIT_METHODS = frozenset({
    "emit", "span", "instant", "counter",
    "async_begin", "async_end", "async_instant",
})


def _in_dirs(relpath: str, dirs: Sequence[str]) -> bool:
    return any(relpath == d or relpath.startswith(d) for d in dirs)


class TracerEmitGuard(Rule):
    name = "tracer-emit-guard"
    description = (
        "every tracer emit (emit/span/instant/counter/async_*) must be "
        "dominated by a `tracer is not None` guard"
    )

    SCOPE = ("core/", "obs/", "launch/", "models/", "distributed/")

    def applies(self, relpath: str) -> bool:
        return _in_dirs(relpath, self.SCOPE)

    def check(self, module: Module) -> List[Finding]:
        out: List[Finding] = []
        # cache of per-function tracer aliases (tr = self.tracer)
        alias_cache: dict = {}
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if not (isinstance(f, ast.Attribute) and f.attr in _EMIT_METHODS):
                continue
            recv = f.value
            func = enclosing_function(node, module)
            aliases = alias_cache.get(id(func))
            if aliases is None and func is not None:
                aliases = local_aliases(func, _is_tracer_expr)
                alias_cache[id(func)] = aliases
            if not _is_tracer_expr(recv, aliases or set()):
                continue  # not a tracer (e.g. collections.Counter)
            recv_s = unparse(recv)
            not_none, _ = dominating_facts(node, module)
            if recv_s not in not_none:
                out.append(Finding(
                    self.name, module.relpath, node.lineno,
                    f"`{recv_s}.{f.attr}(...)` is not dominated by a "
                    f"`{recv_s} is not None` guard — tracing is optional "
                    "and this crashes un-traced runs",
                ))
        return out


def _is_tracer_expr(expr: ast.AST, aliases: Set[str] = frozenset()) -> bool:
    if isinstance(expr, ast.Name):
        return expr.id in {"tracer", "tr"} or expr.id in aliases
    if isinstance(expr, ast.Attribute):
        return expr.attr in {"tracer", "_tracer"}
    return False


class NoOrderedCallbackInTP(ProjectRule):
    name = "no-ordered-callback-in-tp"
    description = (
        "no io_callback(..., ordered=True) reachable from a "
        "`with tp_body(...)` block (shard_map does not support ordered "
        "callbacks); an `tp_axis() is None` branch exempts the ordered arm"
    )

    def check_project(self, modules: Sequence[Module]) -> List[Finding]:
        index = FunctionIndex(modules)
        # seed: functions that contain a `with tp_body(...)` block, plus
        # everything called inside such a block
        seeds: Set[str] = set()
        for qual, info in index.functions.items():
            for call in info.calls:
                fname = call.func
                name = (
                    fname.id if isinstance(fname, ast.Name)
                    else fname.attr if isinstance(fname, ast.Attribute)
                    else None
                )
                if name == "tp_body":
                    seeds.add(qual)
        # propagate reachability through the call graph
        reachable: Set[str] = set()
        frontier = list(seeds)
        while frontier:
            qual = frontier.pop()
            if qual in reachable:
                continue
            reachable.add(qual)
            info = index.functions[qual]
            for call in info.calls:
                for callee in index.resolve_call(call, info):
                    if callee not in reachable:
                        frontier.append(callee)
        out: List[Finding] = []
        for qual in sorted(reachable):
            info = index.functions[qual]
            for call in info.calls:
                if not _is_io_callback(call.func):
                    continue
                ordered = _kw_true(call, "ordered")
                if not ordered:
                    continue
                # exemption: dominated by `ax is None` where ax = tp_axis()
                probes = local_aliases(info.node, _is_tp_axis_call)
                _, is_none = dominating_facts(call, info.module)
                if probes & is_none:
                    continue
                out.append(Finding(
                    self.name, info.module.relpath, call.lineno,
                    f"io_callback(..., ordered=True) in `{info.shortname}` "
                    "is reachable from a tp_body block — ordered callbacks "
                    "are unsupported inside shard_map; use ordered=False + "
                    "axis_index, or guard behind `tp_axis() is None`",
                ))
        return out


def _is_io_callback(func: ast.AST) -> bool:
    if isinstance(func, ast.Name):
        return func.id == "io_callback"
    if isinstance(func, ast.Attribute):
        return func.attr == "io_callback"
    return False


def _is_tp_axis_call(expr: ast.AST) -> bool:
    return (
        isinstance(expr, ast.Call)
        and (
            (isinstance(expr.func, ast.Name) and expr.func.id == "tp_axis")
            or (isinstance(expr.func, ast.Attribute) and expr.func.attr == "tp_axis")
        )
    )


def _kw_true(call: ast.Call, name: str) -> bool:
    for kw in call.keywords:
        if kw.arg == name:
            return isinstance(kw.value, ast.Constant) and kw.value.value is True
    return False


class PageOwnership(Rule):
    name = "page-ownership"
    description = (
        "KV page lifetime goes through PagePool.alloc/incref/free only; "
        "no direct `_free` free-list or `_ref` refcount access on another "
        "object outside kv_cache.py"
    )

    OWNER = "core/kv_cache.py"
    PRIVATE = frozenset({"_free", "_ref"})

    def applies(self, relpath: str) -> bool:
        return relpath != self.OWNER

    def check(self, module: Module) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Attribute) and node.attr in self.PRIVATE:
                recv = node.value
                if isinstance(recv, ast.Name) and recv.id in {"self", "cls"}:
                    continue  # a class's own private state, not a pool's
                out.append(Finding(
                    self.name, module.relpath, node.lineno,
                    f"direct access to `{unparse(node)}` bypasses the "
                    "refcounted PagePool.alloc/incref/free protocol",
                ))
            elif (
                isinstance(node, ast.Attribute)
                and node.attr == "free_pages"
                and isinstance(node.ctx, (ast.Store, ast.Del))
            ):
                out.append(Finding(
                    self.name, module.relpath, node.lineno,
                    "`free_pages` is a read-only derived view; page "
                    "lifetime changes must go through alloc/incref/free",
                ))
        return out


class SpanClock(Rule):
    name = "span-clock"
    description = (
        "the span timeline and overlap accounting share one monotonic "
        "clock domain (time.perf_counter); time.time is banned in the "
        "package (wall clock lives at the benchmark edges only)"
    )

    SCOPE = ("core/", "obs/", "launch/", "models/", "distributed/", "data/")

    def applies(self, relpath: str) -> bool:
        return _in_dirs(relpath, self.SCOPE)

    def check(self, module: Module) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(module.tree):
            if (
                isinstance(node, ast.Attribute)
                and node.attr == "time"
                and isinstance(node.value, ast.Name)
                and node.value.id == "time"
            ):
                out.append(Finding(
                    self.name, module.relpath, node.lineno,
                    "time.time() mixes wall clock into the perf_counter "
                    "span domain — use time.perf_counter()",
                ))
            elif isinstance(node, ast.ImportFrom) and node.module == "time":
                for alias in node.names:
                    if alias.name == "time":
                        out.append(Finding(
                            self.name, module.relpath, node.lineno,
                            "`from time import time` imports the wall "
                            "clock — use time.perf_counter()",
                        ))
        return out


class NoWallClockInPlan(Rule):
    name = "no-wall-clock-in-plan"
    description = (
        "scheduler/perfmodel stay pure functions of queue + pool state: "
        "no time.* access (timing side effects belong to the engine loop)"
    )

    SCOPE = ("core/scheduler.py", "core/perfmodel.py")

    def applies(self, relpath: str) -> bool:
        return relpath in self.SCOPE

    def check(self, module: Module) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(module.tree):
            if (
                isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "time"
            ):
                out.append(Finding(
                    self.name, module.relpath, node.lineno,
                    f"`time.{node.attr}` inside the planner — plan() must "
                    "be a pure function of its inputs so plan-ahead "
                    "signature revalidation stays deterministic",
                ))
            elif isinstance(node, ast.ImportFrom) and node.module == "time":
                out.append(Finding(
                    self.name, module.relpath, node.lineno,
                    "importing from `time` inside the planner",
                ))
        return out


INVARIANT_RULES = (
    TracerEmitGuard,
    NoOrderedCallbackInTP,
    PageOwnership,
    SpanClock,
    NoWallClockInPlan,
)
