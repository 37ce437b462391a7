"""The port's static analyzer (``repro_torch.analysis``) against the JAX
package's (``repro.analysis``): pure AST, no device, a few seconds.

1. Under ``--profile reference`` over ``src/repro`` the port's analyzer
   gives the reference's ``--strict --format json`` findings exactly.
2. Every fixture snippet of ``tests/test_analysis.py`` (each rule's
   violating, clean and suppressed variants, the suppression meta rules,
   the role audit and the lock cycles) gives the same findings through
   both analyzers, one parametrised case each.
3. Over ``src/repro_torch`` under the port's profile ``--strict`` is
   clean, with no stale whitelist entry.
4. Role units: each of the port's thread entry points is seeded and
   reaches what it runs.
5. Mutations of the real tree (an unlocked write from a shard thread, and
   from a copy job) are flagged.
6. The CLI's exit codes.
"""

import json
import textwrap
from pathlib import Path

import pytest

import repro.analysis as ref_analysis
from repro.analysis.__main__ import main as ref_main
from repro.analysis.lint import Module as RefModule
from repro.analysis.lint import run_rules as ref_run_rules

from repro_torch.testing import one_thread  # noqa: E402,F401
import repro_torch.analysis as port_analysis
from repro_torch.analysis import (
    EXPECTED_CLEAN,
    PORT,
    REFERENCE,
    SHARED_STATE_WHITELIST,
    check_baseline,
    default_root,
    run_analysis,
    unsuppressed,
)
from repro_torch.analysis.__main__ import main as port_main
from repro_torch.analysis.baseline import REFERENCE_EXPECTED_CLEAN
from repro_torch.analysis.graph import FunctionIndex
from repro_torch.analysis.lint import Module, load_tree, run_rules
from repro_torch.analysis.roles import ROLE_SCOPE, LockOrder, RoleChecker, _scope

REPO = Path(__file__).resolve().parent.parent
REF_ROOT = str(REPO / "src" / "repro")


def _dicts(findings):
    return [f.to_dict() for f in findings]


# ---------------------------------------------------------------------------
# 1. the reference's findings over its own tree
# ---------------------------------------------------------------------------

def test_reference_profile_reproduces_reference_findings():
    want = ref_analysis.run_analysis(strict=True)
    got = run_analysis(REF_ROOT, strict=True, profile="reference")
    assert _dicts(got) == _dicts(want)
    assert len(got) == 2 and all(f.suppressed for f in got)


def test_reference_profile_cli_json_matches_reference_cli(capsys):
    assert ref_main(["--strict", "--format", "json"]) == 0
    want = json.loads(capsys.readouterr().out)
    assert port_main(["--root", REF_ROOT, "--profile", "reference", "--strict",
                      "--format", "json"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got.pop("tool") == "repro_torch.analysis"
    assert want.pop("tool") == "repro.analysis"
    assert got == want


def test_reference_tables_copied_verbatim():
    from repro.analysis import baseline as ref_baseline
    from repro.analysis import roles as ref_roles

    assert dict(REFERENCE.seeds) == ref_roles.ROLE_SEEDS
    assert dict(REFERENCE.whitelist) == ref_roles.SHARED_STATE_WHITELIST
    assert ROLE_SCOPE == ref_roles.ROLE_SCOPE
    assert REFERENCE_EXPECTED_CLEAN == ref_baseline.EXPECTED_CLEAN


# ---------------------------------------------------------------------------
# 2. tests/test_analysis.py's fixtures through both analyzers
# ---------------------------------------------------------------------------

_EMIT_UNGUARDED = """
class C:
    def f(self):
        tr = self.tracer
        tr.emit("t", "n", 0.0, 1.0, {})
"""
_EMIT_GUARDED = """
class C:
    def f(self):
        tr = self.tracer
        if tr is not None:
            tr.emit("t", "n", 0.0, 1.0, {})
        t0 = time.perf_counter() if tr is not None else 0.0
        x = tr.counter("t", "c", 0.0, 1) if tr is not None else None
"""
_EMIT_EARLY_RETURN = """
class C:
    def f(self):
        tr = self.tracer
        if tr is None:
            return
        with tr.span("t", "n"):
            tr.instant("t", "i")
"""
_EMIT_CLOSURE = """
class C:
    def launch(self):
        tr = self.tracer
        def job():
            if tr is not None:
                tr.emit("copy-out", "out", 0.0, 1.0, {})
        return job
"""
_EMIT_WRONG_GUARD = """
class C:
    def f(self, other):
        tr = self.tracer
        if other is not None:
            tr.emit("t", "n", 0.0, 1.0, {})
"""
_EMIT_SUPPRESSED = """
class C:
    def f(self):
        tr = self.tracer
        # repro-lint: allow[tracer-emit-guard] -- fixture: tr is proven non-None by construction here
        tr.emit("t", "n", 0.0, 1.0, {})
"""
_TP_ORDERED = """
def body(x):
    return io_callback(cb, None, x, ordered=True)

def entry(x):
    with tp_body("model"):
        return body(x)
"""
_TP_UNORDERED = """
def body(x):
    return io_callback(cb, None, x, ordered=False)

def entry(x):
    with tp_body("model"):
        return body(x)

def lane_only(x):
    # ordered is fine here: nothing reaches this from a tp_body block
    return io_callback(cb, None, x, ordered=True)
"""
_TP_AXIS_GUARD = """
def body(x):
    ax = tp_axis()
    if ax is None:
        return io_callback(cb, None, x, ordered=True)
    return io_callback(cb_tp, None, x, ordered=False)

def entry(x):
    with tp_body("model"):
        return body(x)
"""
_TP_SUPPRESSED = """
def body(x):
    # repro-lint: allow[no-ordered-callback-in-tp] -- fixture: callback body is shard-invariant by design
    return io_callback(cb, None, x, ordered=True)

def entry(x):
    with tp_body("model"):
        return body(x)
"""
_PAGE_LEAK = """
def leak(pool):
    pool._free.append(3)
    pool._ref[0] -= 1
"""
_PAGE_API = """
class MyPool:
    def __init__(self):
        self._free = []
    def release(self, pool, pages):
        pool.free(pages)      # the sanctioned API
        self._free.extend(pages)  # this class's OWN free list
"""
_PAGE_SUPPRESSED = """
def fixup(pool):
    # repro-lint: allow[page-ownership] -- fixture: test-only invariant check reading the free list
    pool._free.sort()
"""
_CLOCK_WALL = """
import time
def f():
    return time.time()
"""
_CLOCK_PERF = """
import time
def f():
    return time.perf_counter()
"""
_CLOCK_SUPPRESSED = """
import time
def f():
    # repro-lint: allow[span-clock] -- fixture: wall-clock needed for an absolute deadline label
    return time.time()
"""
_PLAN_SUPPRESSED = """
import time
def plan(tr):
    # repro-lint: allow[no-wall-clock-in-plan] -- fixture: guarded tracer timestamp, plan content is clock-free
    return time.perf_counter() if tr is not None else 0.0
"""
_BARE_ALLOW = """
import time
def f():
    # repro-lint: allow[span-clock] -- nope
    return time.time()
"""
_UNKNOWN_ALLOW = """
def f():
    # repro-lint: allow[no-such-rule] -- a perfectly long justification
    return 1
"""
_STALE_ALLOW = """
def f():
    # repro-lint: allow[span-clock] -- this allow no longer matches any finding
    return 1
"""
_ROLE_RACE = """
class Eng:
    def __init__(self):
        self.x = 0
    def step(self):  # repro-role: engine
        self.x += 1
    def worker(self):  # repro-role: copy-stream
        return self.x
"""
_ROLE_LOCKED = """
class Eng:
    def __init__(self):
        self.x = 0
    def step(self):  # repro-role: engine
        with self._lock:
            self.x += 1
    def worker(self):  # repro-role: copy-stream
        with self._lock:
            return self.x
"""
_ROLE_SINGLE = """
class Eng:
    def __init__(self):
        self.x = 0          # construction happens-before thread start
    def step(self):  # repro-role: engine
        self.x += 1
    def also_engine(self):  # repro-role: engine
        return self.x
"""
_LOCK_CYCLE = """
class A:
    def f(self):
        with self.lock_a:
            with self.lock_b:
                pass
    def g(self):
        with self.lock_b:
            with self.lock_a:
                pass
"""
_LOCK_INTERPROC = """
class A:
    def f(self):
        with self.lock_a:
            self.helper()
    def helper(self):
        with self.lock_b:
            pass
    def g(self):
        with self.lock_b:
            with self.lock_a:
                pass
"""
_LOCK_CLEAN = """
class A:
    def f(self):
        with self.lock_a:
            with self.lock_b:
                pass
    def g(self):
        with self.lock_a:
            with self.lock_b:
                pass
"""

# (id, rule class name, fixture relpath, strict, source, findings expected)
FIXTURES = [
    ("emit-unguarded", "TracerEmitGuard", "core/fixture.py", False, _EMIT_UNGUARDED, 1),
    ("emit-if-and-ternary", "TracerEmitGuard", "core/fixture.py", False, _EMIT_GUARDED, 0),
    ("emit-early-return", "TracerEmitGuard", "core/fixture.py", False, _EMIT_EARLY_RETURN, 0),
    ("emit-closure", "TracerEmitGuard", "core/fixture.py", False, _EMIT_CLOSURE, 0),
    ("emit-wrong-guard", "TracerEmitGuard", "core/fixture.py", False, _EMIT_WRONG_GUARD, 1),
    ("emit-suppressed", "TracerEmitGuard", "core/fixture.py", True, _EMIT_SUPPRESSED, 1),
    ("tp-ordered", "NoOrderedCallbackInTP", "core/fixture.py", False, _TP_ORDERED, 1),
    ("tp-unordered", "NoOrderedCallbackInTP", "core/fixture.py", False, _TP_UNORDERED, 0),
    ("tp-axis-guard", "NoOrderedCallbackInTP", "core/fixture.py", False, _TP_AXIS_GUARD, 0),
    ("tp-suppressed", "NoOrderedCallbackInTP", "core/fixture.py", True, _TP_SUPPRESSED, 1),
    ("page-leak", "PageOwnership", "core/other.py", False, _PAGE_LEAK, 2),
    ("page-api", "PageOwnership", "serving/sim.py", False, _PAGE_API, 0),
    ("page-suppressed", "PageOwnership", "core/fixture.py", True, _PAGE_SUPPRESSED, 1),
    ("clock-wall", "SpanClock", "obs/fixture.py", False, _CLOCK_WALL, 1),
    ("clock-from-import", "SpanClock", "core/fixture.py", False, "from time import time\n", 1),
    ("clock-perf-counter", "SpanClock", "core/fixture.py", False, _CLOCK_PERF, 0),
    ("clock-suppressed", "SpanClock", "core/fixture.py", True, _CLOCK_SUPPRESSED, 1),
    ("plan-clock", "NoWallClockInPlan", "core/scheduler.py", False, _CLOCK_PERF, 1),
    ("plan-suppressed", "NoWallClockInPlan", "core/scheduler.py", True, _PLAN_SUPPRESSED, 1),
    ("meta-bare-allow", "SpanClock", "core/fixture.py", True, _BARE_ALLOW, 2),
    ("meta-unknown-rule", "SpanClock", "core/fixture.py", True, _UNKNOWN_ALLOW, 1),
    ("meta-stale-allow", "SpanClock", "core/fixture.py", True, _STALE_ALLOW, 1),
    ("role-race", "RoleChecker", "core/fixture.py", False, _ROLE_RACE, 1),
    ("role-locked", "RoleChecker", "core/fixture.py", False, _ROLE_LOCKED, 0),
    ("role-single-and-init", "RoleChecker", "core/fixture.py", False, _ROLE_SINGLE, 0),
    ("lock-cycle", "LockOrder", "core/fixture.py", False, _LOCK_CYCLE, 1),
    ("lock-interprocedural", "LockOrder", "core/fixture.py", False, _LOCK_INTERPROC, 1),
    ("lock-clean", "LockOrder", "core/fixture.py", False, _LOCK_CLEAN, 0),
]


def _fixture_findings(pkg, module_cls, run, rule_name, relpath, strict, src):
    mod = module_cls("<fixture>", relpath, textwrap.dedent(src))
    rule = getattr(pkg, rule_name)()
    if rule_name in ("RoleChecker", "LockOrder"):  # as tests/test_analysis.py calls them
        return _dicts(rule.check_project([mod]))
    return _dicts(run([mod], [rule], strict=strict))


@pytest.mark.parametrize("case", FIXTURES, ids=[c[0] for c in FIXTURES])
def test_fixture_findings_match_reference(case):
    _, rule_name, relpath, strict, src, n = case
    want = _fixture_findings(ref_analysis, RefModule, ref_run_rules, rule_name, relpath,
                             strict, src)
    got = _fixture_findings(port_analysis, Module, run_rules, rule_name, relpath,
                            strict, src)
    assert got == want
    assert len(got) == n, got


def test_scopes_and_baseline_annotation_match_reference():
    from repro.analysis.rules import NoWallClockInPlan as RefPlan
    from repro.analysis.rules import PageOwnership as RefPages
    from repro_torch.analysis.rules import NoWallClockInPlan, PageOwnership

    for path in ("core/kv_cache.py", "core/engine.py", "core/scheduler.py",
                 "core/perfmodel.py", "obs/x.py"):
        assert PageOwnership().applies(path) == RefPages().applies(path)
        assert NoWallClockInPlan().applies(path) == RefPlan().applies(path)
    fs = run_rules([Module("<fixture>", "core/util.py", "from time import time\n")],
                   [port_analysis.SpanClock()])
    ref_fs = ref_run_rules([RefModule("<fixture>", "core/util.py", "from time import time\n")],
                           [ref_analysis.SpanClock()])
    assert _dicts(check_baseline(fs, REFERENCE_EXPECTED_CLEAN)) == _dicts(
        ref_analysis.check_baseline(ref_fs))
    extra = check_baseline(fs)
    assert len(extra) == 1 and extra[0].rule == "baseline" and "span-clock" in extra[0].message


# ---------------------------------------------------------------------------
# 3. the port's tree under its own profile
# ---------------------------------------------------------------------------

def test_port_tree_strict_is_clean():
    fs = run_analysis(strict=True)
    bad = unsuppressed(fs)
    assert bad == [], "\n".join(str(f) for f in bad)
    sup = [f for f in fs if f.suppressed]
    # the scheduler's two tracer timestamps and the emit-cost timer
    assert sorted((f.path, f.rule) for f in sup) == [
        ("core/scheduler.py", "no-wall-clock-in-plan"),
        ("core/scheduler.py", "no-wall-clock-in-plan"),
        ("obs/overhead.py", "tracer-emit-guard")]
    assert all(len(f.justification) >= 10 for f in sup)


def test_port_whitelist_entries_all_used_and_documented(port_index):
    index, _, _ = port_index
    rc = RoleChecker()
    fs = rc.check_project(load_tree(default_root()))
    assert fs == [], "\n".join(str(f) for f in fs)
    # every entry names a class of the tree and is matched (no stale finding)
    classes = {i.classname for i in index.functions.values()}
    for (cls, attr), why in SHARED_STATE_WHITELIST.items():
        assert cls in classes, cls
        assert len(why) >= 20, (cls, attr)
    for rule, glob, note in EXPECTED_CLEAN:
        assert len(note) >= 20
    # the reference's io_callback slots and jit caches are not the port's
    for key in (("PagePool", "k"), ("PagedExecutor", "_cb_lane_state"),
                ("PagedExecutor", "_prefill_fns")):
        assert key not in SHARED_STATE_WHITELIST
    assert PORT.seeds["host-callback"] == ()


# ---------------------------------------------------------------------------
# 4. role units over the port's tree
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_index():
    index = FunctionIndex(_scope(load_tree(default_root())))
    roles = RoleChecker().propagate(index)

    def roles_of(shortname):
        quals = index.by_shortname(shortname)
        assert quals, f"no function named {shortname}"
        out = set()
        for q in quals:
            out |= roles[q]
        return out

    return index, roles, roles_of


# (function, roles it must have, roles it must not have)
ROLE_UNITS = [
    ("PagedExecutor.submit_host_lane.<locals>.run_lane", {"lane"}, {"engine"}),
    ("PagedExecutor.decode_host_lane", {"lane", "engine"}, set()),
    ("HostAttention.run_layer", {"lane", "engine", "per-shard-callback"}, set()),
    ("PagedExecutor._prefill_cached.<locals>.host_leg", {"lane"}, {"engine"}),
    ("PagedExecutor._prefill_cached_host", {"lane", "engine"}, set()),
    ("PagedExecutor._host_prefix_cb", {"lane", "engine"}, set()),
    ("HostAttention.prefix_partials", {"lane", "engine", "per-shard-callback"}, set()),
    ("PagedExecutor._host_shard_layer", {"per-shard-callback"}, {"engine", "lane"}),
    ("PagedExecutor._host_prefix_cb_tp.<locals>.shard_partials", {"per-shard-callback"},
     {"engine", "lane"}),
    ("HostAttention.run_layer.<locals>.work", {"host-attn-worker"}, set()),
    ("HostAttention._row_attention", {"host-attn-worker", "lane"}, set()),
    ("TransferEngine._run", {"copy-stream"}, {"engine"}),
    ("TransferEngine.swap_out.<locals>.copy", {"copy-stream"}, {"engine"}),
    ("TransferEngine.swap_in.<locals>.gather", {"copy-stream"}, {"engine"}),
    ("TransferEngine.swap_in.<locals>.apply", {"engine"}, {"copy-stream"}),
    ("PagePool.scatter", {"copy-stream", "engine"}, set()),
    ("NeoEngine._step_paged.<locals>._pre.<locals>.join_out", {"lane"}, {"engine"}),
    ("TransferEngine.join_requests", {"lane", "engine"}, set()),
    ("NeoEngine._launch_planahead.<locals>._plan_spec", {"planner"}, {"engine"}),
    ("NeoScheduler.plan", {"planner", "engine"}, set()),
    # seeded: their names are on the call graph's stoplist
    ("PagedExecutor.decode", {"engine"}, {"lane", "per-shard-callback"}),
    ("PagedExecutor._host_attention_tp", {"engine"}, {"per-shard-callback"}),
    ("ContiguousExecutor.decode", {"engine"}, set()),
    ("PrefixCache.insert", {"engine"}, {"planner", "lane"}),
    ("PagePool.free", {"engine"}, {"lane", "copy-stream", "planner"}),
    ("PagePool.alloc", {"engine"}, {"lane", "copy-stream", "planner"}),
]


@pytest.mark.parametrize("unit", ROLE_UNITS, ids=[u[0] for u in ROLE_UNITS])
def test_port_role_units(port_index, unit):
    _, _, roles_of = port_index
    name, must, must_not = unit
    got = roles_of(name)
    assert must <= got, (name, got)
    assert not (must_not & got), (name, got)


# ---------------------------------------------------------------------------
# 5. mutations of the real tree are flagged
# ---------------------------------------------------------------------------

def _mutated(relpath, *edits):
    """The port's tree with ``relpath``'s source edited by each (old, new)."""
    out = []
    for m in load_tree(default_root()):
        if m.relpath == relpath:
            src = m.source
            for old, new in edits:
                assert old in src, old
                src = src.replace(old, new, 1)
            m = Module(m.path, m.relpath, src)
        out.append(m)
    return out


def test_mutation_shard_thread_write_read_by_engine_is_flagged():
    # a shard job records its row count on the executor, and the decode
    # pass NeoEngine.step runs reads it: a cross-role race
    mods = _mutated(
        "core/executor.py",
        ("        tables, lens, pids, offs = h_meta\n        tr = self.tracer\n",
         "        tables, lens, pids, offs = h_meta\n        self.shard_rows = len(lens)\n"
         "        tr = self.tracer\n"),
        ("        n, page, dev = len(rows), self.page, self.device\n",
         "        n, page, dev = len(rows), self.page, self.device\n"
         "        stale = self.shard_rows\n"))
    fs = RoleChecker().check_project(mods)
    assert len(fs) == 1, [str(f) for f in fs]
    assert "`PagedExecutor.shard_rows`" in fs[0].message
    assert "engine" in fs[0].message and "per-shard-callback" in fs[0].message


def test_mutation_copy_job_unlocked_write_is_flagged():
    # a copy job that drops its handle from _pending without the lock
    mods = _mutated("core/transfer.py",
                    ("            host.scatter(new_pages, k_h, v_h, part)\n",
                     "            host.scatter(new_pages, k_h, v_h, part)\n"
                     "            self._pending = [p for p in self._pending if p is not handle]\n"))
    fs = RoleChecker().check_project(mods)
    assert len(fs) == 1, [str(f) for f in fs]
    assert "`TransferEngine._pending`" in fs[0].message
    assert "copy-stream" in fs[0].message and "unlocked" in fs[0].message


# ---------------------------------------------------------------------------
# 6. the CLI
# ---------------------------------------------------------------------------

def test_cli_exit_codes(tmp_path, capsys):
    pkg = tmp_path / "badpkg"
    (pkg / "core").mkdir(parents=True)
    (pkg / "core" / "bad.py").write_text("import time\n\ndef f():\n    return time.time()\n")
    out = tmp_path / "report.json"
    assert port_main(["--root", str(pkg), "--strict", "--format", "json",
                      "--output", str(out)]) == 1
    doc = json.loads(out.read_text())
    assert doc["counts"]["findings"] == 2
    assert {f["rule"] for f in doc["findings"]} == {"span-clock", "baseline"}
    assert port_main([]) == 0  # the port's package, its profile
    assert port_main(["--strict"]) == 0
    text = capsys.readouterr().out
    assert "repro_torch.analysis: 0 finding(s), 3 suppressed [strict]" in text
    # the reference's role map over the port's tree: its io_callback slots
    # and jit caches are stale there
    assert port_main(["--strict", "--profile", "reference"]) == 1
    text = capsys.readouterr().out
    assert "whitelist entry `PagedExecutor._cb_lane_state` no longer matches" in text
    with pytest.raises(SystemExit):
        port_main(["--profile", "jax"])


def test_all_rules_have_names_and_descriptions():
    names = [r.name for r in port_analysis.all_rules()]
    assert names == [r.name for r in ref_analysis.all_rules()]
    for r in port_analysis.all_rules(profile="reference"):
        assert r.name and r.description
