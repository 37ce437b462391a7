"""Expected-clean baseline: the regression registry for triaged findings
(the port's copy of the JAX package's ``analysis/baseline.py``, with a
registry per profile).

Every violation class triaged while bringing the analyzer up got either a
*fix* (recorded here so it cannot silently return) or a justified inline
``# repro-lint: allow[...]``.  Each entry pins one (rule, path) pair that
is expected to stay clean, with the note explaining what made it clean —
when a future change re-introduces the violation, the plain finding is
augmented with a ``baseline`` finding carrying that context, so the CI
failure says *which settled decision* the change unwinds.
"""

from __future__ import annotations

from fnmatch import fnmatch
from typing import Dict, List, Sequence, Tuple

from .lint import Finding

__all__ = ["EXPECTED_CLEAN", "REFERENCE_EXPECTED_CLEAN", "BASELINES", "check_baseline"]

Baseline = Tuple[Tuple[str, str, str], ...]

# (rule, path-glob, why-this-is-clean) of the port's tree
EXPECTED_CLEAN: Baseline = (
    (
        "tracer-emit-guard", "core/*.py",
        "every emit in the engine core is dominated by an `is not None` "
        "guard (tracing is attachable after construction; an unguarded "
        "emit crashes un-traced serves inside worker threads)",
    ),
    (
        "tracer-emit-guard", "obs/*.py",
        "the observability layer itself never emits unguarded; the one "
        "emit on a tracer built in place (obs/overhead.py's emit-cost "
        "timer) carries a justified allow",
    ),
    (
        "no-ordered-callback-in-tp", "*",
        "no io_callback in the port: host attention runs on the caller's "
        "thread or on the port's own thread pools, and gather-TP has no "
        "shard_map body, so the rule has nothing to match",
    ),
    (
        "page-ownership", "*",
        "no module outside kv_cache.py touches a pool's `_free` list or "
        "`_ref` counts; page lifetime goes through alloc/incref/free only",
    ),
    (
        "span-clock", "*",
        "the package has a single monotonic clock domain "
        "(time.perf_counter); wall clock lives at the benchmark edges "
        "outside the engine's layers",
    ),
    (
        "no-wall-clock-in-plan", "core/scheduler.py",
        "plan() is a pure function of queue + pool state; the only two "
        "time.perf_counter sites are guarded tracer timestamps carrying "
        "justified allows",
    ),
    (
        "no-wall-clock-in-plan", "core/perfmodel.py",
        "the perf model estimates from calibrated constants and EMAs "
        "updated engine-side — no clock reads during estimation",
    ),
    (
        "cross-role-state", "core/kv_cache.py",
        "PagePool._free/_ref are engine-role-only: page metadata moves "
        "synchronously at swap launch/join on the engine thread, and only "
        "the data copies ride the copy-stream workers (the swap closures "
        "carry `# repro-role:` annotations pinning this); DualPool's swap "
        "byte counter is written under its own lock",
    ),
    (
        "cross-role-state", "core/transfer.py",
        "TransferEngine state is either engine-role (launch/join/close), "
        "lock-protected (stats, _pending, a handle's job count), "
        "Event-mediated (TransferHandle), or the whitelisted post-close "
        "`_closed` handoff from the hardened idempotent close()",
    ),
    (
        "cross-role-state", "core/host_attention.py",
        "HostAttention's counters are written under _acct_lock; its pool "
        "views are written only at page/row granularity by the one thread "
        "that owns the row in this step (whitelisted handoff)",
    ),
    (
        "lock-order", "*",
        "locks are leaf-level (stats/accounting) — nothing nests, so the "
        "acquisition digraph stays trivially acyclic",
    ),
)

# The JAX package's registry, verbatim (``repro/analysis/baseline.py``).
REFERENCE_EXPECTED_CLEAN: Baseline = (
    (
        "tracer-emit-guard", "core/*.py",
        "every emit in the engine core is dominated by an `is not None` "
        "guard (tracing is attachable after construction; an unguarded "
        "emit crashes un-traced serves inside worker threads)",
    ),
    (
        "tracer-emit-guard", "obs/*.py",
        "the observability layer itself never emits unguarded",
    ),
    (
        "no-ordered-callback-in-tp", "core/executor.py",
        "_layer_step keeps its ordered=True host callback behind the "
        "`tp_axis() is None` branch; the TP arm uses ordered=False + "
        "jax.lax.axis_index (ordered callbacks are unsupported in "
        "shard_map)",
    ),
    (
        "page-ownership", "*",
        "no module outside kv_cache.py touches a pool's `_free` list or "
        "`_ref` counts; page lifetime goes through alloc/incref/free only",
    ),
    (
        "span-clock", "*",
        "the package has a single monotonic clock domain "
        "(time.perf_counter); wall clock lives at the benchmark edges "
        "outside src/repro",
    ),
    (
        "no-wall-clock-in-plan", "core/scheduler.py",
        "plan() is a pure function of queue + pool state; the only two "
        "time.perf_counter sites are guarded tracer timestamps carrying "
        "justified allows",
    ),
    (
        "no-wall-clock-in-plan", "core/perfmodel.py",
        "the perf model estimates from calibrated constants and EMAs "
        "updated engine-side — no clock reads during estimation",
    ),
    (
        "cross-role-state", "core/kv_cache.py",
        "PagePool._free/_ref are engine-role-only: page metadata moves "
        "synchronously at swap launch/join on the engine thread, and only "
        "the data copies ride the copy-stream workers (the swap closures "
        "carry `# repro-role:` annotations pinning this)",
    ),
    (
        "cross-role-state", "core/transfer.py",
        "TransferEngine state is either engine-role (launch/join/close), "
        "lock-protected (stats, _pending), Event-mediated "
        "(TransferHandle), or the whitelisted post-close `_closed` "
        "handoff from the hardened idempotent close()",
    ),
    (
        "lock-order", "*",
        "locks are leaf-level (stats/accounting) — nothing nests, so the "
        "acquisition digraph stays trivially acyclic",
    ),
)

BASELINES: Dict[str, Baseline] = {"port": EXPECTED_CLEAN,
                                  "reference": REFERENCE_EXPECTED_CLEAN}


def check_baseline(findings: Sequence[Finding],
                   expected: Baseline = EXPECTED_CLEAN) -> List[Finding]:
    """For every unsuppressed finding that regresses an ``expected`` entry,
    add a ``baseline`` finding pointing at the settled decision."""
    out: List[Finding] = []
    for f in findings:
        if f.suppressed:
            continue
        for rule, glob, note in expected:
            if f.rule == rule and fnmatch(f.path, glob):
                out.append(Finding(
                    "baseline", f.path, f.line,
                    f"regression of an expected-clean baseline entry "
                    f"({rule} on {glob}): {note}",
                ))
                break
    return out
