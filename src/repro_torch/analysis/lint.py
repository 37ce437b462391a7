"""Core of the repo-specific static analyzer: module loading, suppression
parsing, guard/dominance helpers, and the rule runner (the port's copy of
the JAX package's ``analysis/lint.py``; pure stdlib, it reads both trees).

The analyzer is a *standing audit* of the concurrency architecture the same
way ``repro_torch.obs.reconcile`` is a standing audit of the stats: the invariants
that keep greedy outputs bitwise identical (tracer-emit guards, no ordered
callbacks under TP, refcounted page ownership, one clock domain per span)
are enforced here as AST rules instead of living only in ROADMAP prose.

Vocabulary
----------
``Finding``
    One rule violation at a (path, line).  Findings can be *suppressed* by
    an inline ``# repro-lint: allow[rule-name] -- justification`` comment on
    the flagged line or the line immediately above it.  A suppression with
    no ``--`` justification text is itself a finding (rule ``suppression``)
    so exemptions stay documented.
``Module``
    A parsed source file plus the parent map and per-line suppressions.
``Rule``
    Per-module check (``check(module)``).  ``ProjectRule`` subclasses get
    the whole module list at once (``check_project(modules)``) for
    cross-module analyses such as call-graph reachability.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = [
    "Finding",
    "Module",
    "Rule",
    "ProjectRule",
    "load_module",
    "load_tree",
    "run_rules",
    "dominating_facts",
    "guards_not_none",
    "guards_none",
]

# ``allow[rule]`` or ``allow[rule-a,rule-b]`` with an optional justification
# after ``--``.  The justification is required by the ``suppression`` meta
# rule; the regex itself stays permissive so we can diagnose bare allows.
_SUPPRESS_RE = re.compile(
    r"#\s*repro-lint:\s*allow\[([A-Za-z0-9_,\- ]+)\]\s*(?:--\s*(.+?))?\s*$"
)

# Minimum length for a justification to count as "documented" rather than
# a placeholder like "ok".
_MIN_JUSTIFICATION = 10


@dataclass
class Suppression:
    line: int
    rules: Tuple[str, ...]
    justification: str
    used: bool = False

    @property
    def justified(self) -> bool:
        return len(self.justification.strip()) >= _MIN_JUSTIFICATION


@dataclass
class Finding:
    rule: str
    path: str          # repo-relative posix path
    line: int
    message: str
    suppressed: bool = False
    justification: str = ""

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "message": self.message,
            "suppressed": self.suppressed,
            "justification": self.justification,
        }

    def __str__(self) -> str:  # text reporter line
        tag = " (suppressed)" if self.suppressed else ""
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}{tag}"


class Module:
    """A parsed source file with parent links and suppression comments."""

    def __init__(self, path: str, relpath: str, source: str) -> None:
        self.path = path
        self.relpath = relpath.replace(os.sep, "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.parents: Dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent
        self.suppressions: Dict[int, List[Suppression]] = {}
        for i, text in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(text)
            if m is not None:
                rules = tuple(r.strip() for r in m.group(1).split(",") if r.strip())
                sup = Suppression(i, rules, m.group(2) or "")
                self.suppressions.setdefault(i, []).append(sup)

    # -- suppression lookup -------------------------------------------------

    def suppression_for(self, rule: str, line: int) -> Optional[Suppression]:
        """An ``allow[rule]`` on the flagged line or the line just above."""
        for cand in (line, line - 1):
            for sup in self.suppressions.get(cand, ()):
                if rule in sup.rules:
                    # comments on the previous line only apply when that
                    # line is comment-only (mirrors noqa-style placement).
                    if cand == line - 1:
                        stripped = self.lines[cand - 1].strip()
                        if not stripped.startswith("#"):
                            continue
                    return sup
        return None

    def all_suppressions(self) -> Iterable[Suppression]:
        for sups in self.suppressions.values():
            yield from sups


class Rule:
    """Per-module rule.  Subclasses set ``name``/``description`` and
    implement ``check``; ``applies`` scopes the rule to a path subset."""

    name = "rule"
    description = ""

    def applies(self, relpath: str) -> bool:
        return True

    def check(self, module: Module) -> List[Finding]:
        raise NotImplementedError


class ProjectRule(Rule):
    """Whole-project rule: sees every loaded module at once (call-graph
    reachability, role propagation, lock ordering)."""

    def check_project(self, modules: Sequence[Module]) -> List[Finding]:
        raise NotImplementedError

    def check(self, module: Module) -> List[Finding]:  # pragma: no cover
        return []


# ---------------------------------------------------------------------------
# guard / dominance analysis
# ---------------------------------------------------------------------------

def unparse(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:  # pragma: no cover - defensive
        return ast.dump(node)


def guards_not_none(test: ast.expr) -> Set[str]:
    """Expressions proven non-None (well: truthy/not-None) when ``test``
    is true: ``x is not None``, bare ``x``, and ``and`` conjunctions."""
    out: Set[str] = set()
    if isinstance(test, ast.Compare) and len(test.ops) == 1:
        op, comp = test.ops[0], test.comparators[0]
        if isinstance(op, ast.IsNot) and _is_none(comp):
            out.add(unparse(test.left))
        elif isinstance(op, ast.Is) and _is_none(test.left):
            pass  # `None is x` is not used in this repo
    elif isinstance(test, (ast.Name, ast.Attribute)):
        out.add(unparse(test))
    elif isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
        for v in test.values:
            out |= guards_not_none(v)
    return out


def guards_none(test: ast.expr) -> Set[str]:
    """Expressions proven None/falsy when ``test`` is true: ``x is None``,
    ``not x``, and ``and`` conjunctions."""
    out: Set[str] = set()
    if isinstance(test, ast.Compare) and len(test.ops) == 1:
        op, comp = test.ops[0], test.comparators[0]
        if isinstance(op, ast.Is) and _is_none(comp):
            out.add(unparse(test.left))
    elif isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        if isinstance(test.operand, (ast.Name, ast.Attribute)):
            out.add(unparse(test.operand))
    elif isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
        for v in test.values:
            out |= guards_none(v)
    return out


def _is_none(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and node.value is None


_EXIT_STMTS = (ast.Return, ast.Raise, ast.Continue, ast.Break)


def _block_lists(node: ast.AST) -> List[List[ast.stmt]]:
    blocks: List[List[ast.stmt]] = []
    for name in ("body", "orelse", "finalbody"):
        blk = getattr(node, name, None)
        if isinstance(blk, list) and blk and isinstance(blk[0], ast.stmt):
            blocks.append(blk)
    if isinstance(node, ast.Try):
        for h in node.handlers:
            blocks.append(h.body)
    return blocks


def dominating_facts(node: ast.AST, module: Module) -> Tuple[Set[str], Set[str]]:
    """Walk ancestors of ``node`` and collect (not_none, is_none) facts that
    dominate it: enclosing ``if`` branches, ternaries, ``and`` chains, and
    earlier early-exit guards (``if x is None: return``) in any enclosing
    statement block.  The walk deliberately crosses nested-function
    boundaries: a closure created under ``tr = self.tracer`` + guard keeps
    the binding it closed over."""
    not_none: Set[str] = set()
    is_none: Set[str] = set()
    cur: ast.AST = node
    while True:
        par = module.parents.get(cur)
        if par is None:
            break
        if isinstance(par, ast.If):
            if cur in par.body:
                not_none |= guards_not_none(par.test)
                is_none |= guards_none(par.test)
            elif cur in par.orelse:
                # else-branch: the *negation* of the test holds
                not_none |= guards_none(par.test)
                is_none |= guards_not_none(par.test)
        elif isinstance(par, ast.IfExp):
            if cur is par.body:
                not_none |= guards_not_none(par.test)
                is_none |= guards_none(par.test)
            elif cur is par.orelse:
                not_none |= guards_none(par.test)
                is_none |= guards_not_none(par.test)
        elif isinstance(par, ast.BoolOp) and isinstance(par.op, ast.And):
            # `tr is not None and tr.emit(...)` — operands after the first
            # are dominated by the truth of the ones before them.
            vals = par.values
            if cur in vals:
                for earlier in vals[: vals.index(cur)]:
                    not_none |= guards_not_none(earlier)
                    is_none |= guards_none(earlier)
        # early-exit guards earlier in whatever block holds `cur`
        if isinstance(cur, ast.stmt):
            for block in _block_lists(par):
                if cur in block:
                    for stmt in block:
                        if stmt is cur:
                            break
                        if (
                            isinstance(stmt, ast.If)
                            and not stmt.orelse
                            and stmt.body
                            and isinstance(stmt.body[-1], _EXIT_STMTS)
                        ):
                            # `if x is None: return` ⇒ x is not None after
                            not_none |= guards_none(stmt.test)
                            is_none |= guards_not_none(stmt.test)
        cur = par
    return not_none, is_none


def local_aliases(func: ast.AST, is_source) -> Set[str]:
    """Names assigned (anywhere in ``func``) from an expression recognised
    by ``is_source`` — e.g. ``tr = self.tracer`` makes ``tr`` a tracer
    alias, ``ax = tp_axis()`` makes ``ax`` a tp-axis probe."""
    out: Set[str] = set()
    for sub in ast.walk(func):
        if isinstance(sub, ast.Assign) and is_source(sub.value):
            for tgt in sub.targets:
                if isinstance(tgt, ast.Name):
                    out.add(tgt.id)
        elif isinstance(sub, ast.AnnAssign) and sub.value is not None:
            if is_source(sub.value) and isinstance(sub.target, ast.Name):
                out.add(sub.target.id)
    return out


def enclosing_function(node: ast.AST, module: Module) -> Optional[ast.AST]:
    cur = module.parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cur
        cur = module.parents.get(cur)
    return None


# ---------------------------------------------------------------------------
# loading + driving
# ---------------------------------------------------------------------------

def load_module(path: str, root: str) -> Module:
    with open(path, "r", encoding="utf-8") as f:
        src = f.read()
    rel = os.path.relpath(path, root)
    return Module(path, rel, src)


def load_tree(root: str, exclude: Sequence[str] = ("analysis",)) -> List[Module]:
    """Load every ``*.py`` under ``root`` (a package dir: ``repro_torch``,
    or the JAX package's ``repro`` under the reference profile),
    skipping the analyzer itself — its fixtures would trip the rules."""
    modules: List[Module] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in sorted(dirnames) if d != "__pycache__"]
        rel_dir = os.path.relpath(dirpath, root).replace(os.sep, "/")
        if any(rel_dir == e or rel_dir.startswith(e + "/") for e in exclude):
            dirnames[:] = []
            continue
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                modules.append(load_module(os.path.join(dirpath, fn), root))
    return modules


def run_rules(
    modules: Sequence[Module],
    rules: Sequence[Rule],
    strict: bool = False,
) -> List[Finding]:
    """Run every rule, apply suppressions, and (in strict mode) emit the
    meta findings: bare suppressions, unknown rule names in allows, and
    unused allows."""
    findings: List[Finding] = []
    by_path = {m.relpath: m for m in modules}
    for rule in rules:
        if isinstance(rule, ProjectRule):
            raw = rule.check_project(list(modules))
        else:
            raw = []
            for m in modules:
                if rule.applies(m.relpath):
                    raw.extend(rule.check(m))
        for f in raw:
            mod = by_path.get(f.path)
            sup = mod.suppression_for(f.rule, f.line) if mod is not None else None
            if sup is not None:
                sup.used = True
                f.suppressed = True
                f.justification = sup.justification.strip()
            findings.append(f)

    if strict:
        known = {r.name for r in rules}
        for m in modules:
            for sup in m.all_suppressions():
                if not sup.justified:
                    findings.append(Finding(
                        "suppression", m.relpath, sup.line,
                        "allow[] without a `-- justification` (>= "
                        f"{_MIN_JUSTIFICATION} chars): every exemption must "
                        "document why the invariant holds anyway",
                    ))
                for r in sup.rules:
                    if r not in known:
                        findings.append(Finding(
                            "suppression", m.relpath, sup.line,
                            f"allow[{r}] names an unknown rule",
                        ))
                if not sup.used and all(r in known for r in sup.rules):
                    findings.append(Finding(
                        "suppression", m.relpath, sup.line,
                        f"allow[{','.join(sup.rules)}] suppresses nothing "
                        "(stale exemption — delete it)",
                    ))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings
