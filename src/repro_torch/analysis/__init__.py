"""repro_torch.analysis — AST invariant linter + static thread-role race
checker, the port's copy of the JAX package's ``repro.analysis`` (pure
stdlib: it imports neither torch nor anything of ``repro``, and touches no
device).

Run it as ``python -m repro_torch.analysis --strict`` (see ``__main__``),
or use :func:`run_analysis` from tests.  With no ``--root`` it analyzes
the ``repro_torch`` package under the port's role profile;
``--root src/repro --profile reference`` reproduces the JAX package's own
findings.  The rules are the reference's five (:mod:`.rules`) plus the
role and lock-order checkers (:mod:`.roles`, whose docstring holds the
port's thread-role map); ``README.md`` beside this file has the rule
catalog and the triage of the port's tree.  The markers are the
reference's: ``# repro-lint: allow[rule] -- why`` and
``# repro-role: role``.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Union

from .baseline import BASELINES, EXPECTED_CLEAN, check_baseline
from .lint import Finding, Module, ProjectRule, Rule, load_module, load_tree, run_rules
from .report import render_json, render_text, unsuppressed
from .roles import (
    PORT,
    PROFILES,
    REFERENCE,
    ROLE_SEEDS,
    SHARED_STATE_WHITELIST,
    LockOrder,
    Profile,
    RoleChecker,
)
from .rules import (
    INVARIANT_RULES,
    NoOrderedCallbackInTP,
    NoWallClockInPlan,
    PageOwnership,
    SpanClock,
    TracerEmitGuard,
)

__all__ = [
    "Finding",
    "Module",
    "Rule",
    "ProjectRule",
    "Profile",
    "PORT",
    "REFERENCE",
    "all_rules",
    "default_root",
    "run_analysis",
    "render_text",
    "render_json",
    "unsuppressed",
    "ROLE_SEEDS",
    "SHARED_STATE_WHITELIST",
    "EXPECTED_CLEAN",
    "check_baseline",
]


def _profile(profile: Union[str, Profile]) -> Profile:
    return PROFILES[profile] if isinstance(profile, str) else profile


def all_rules(strict: bool = False, profile: Union[str, Profile] = PORT) -> List[Rule]:
    """The full rule set.  The role/lock checkers are project rules and
    always included, the role checker under ``profile``'s role map;
    strictness only changes
    the meta (suppression) findings added by
    :func:`repro_torch.analysis.lint.run_rules`."""
    prof = _profile(profile)
    rules: List[Rule] = [cls() for cls in INVARIANT_RULES]
    rules.append(RoleChecker(prof))
    rules.append(LockOrder())
    return rules


def default_root() -> str:
    """The ``repro_torch`` package directory this module is installed in."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_analysis(
    root: Optional[str] = None,
    strict: bool = True,
    rules: Optional[Sequence[Rule]] = None,
    profile: Union[str, Profile] = PORT,
) -> List[Finding]:
    """Findings over the package at ``root`` (default: ``repro_torch``)
    under ``profile`` ("port" or "reference"): its role map, and in strict
    mode its expected-clean baseline."""
    prof = _profile(profile)
    root = root or default_root()
    modules = load_tree(root)
    findings = run_rules(modules,
                         list(rules) if rules is not None else all_rules(strict, prof),
                         strict=strict)
    if strict:
        findings.extend(check_baseline(findings, BASELINES[prof.name]))
        findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings
