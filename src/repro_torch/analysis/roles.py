"""Static thread-role race checker (the port's copy of the JAX package's
``analysis/roles.py``, with a role profile per tree).

The port's engine runs on these thread roles (:data:`PORT`):

==================  ========================================================
role                where it runs
==================  ========================================================
engine              the caller's thread: submit/offer/step/close and the
                    whole plan → launch → join loop
planner             the single plan-ahead worker (``neo-planner`` pool) that
                    plans iteration N+1 against shadow queues
lane                host-lane threads (``neo-hostlane`` pool) running
                    ``run_lane``, and the ``neo-hostprefix`` thread running
                    ``host_leg``, the host leg of a prefill with host and
                    device prefix hits
copy-stream         per-direction (× per-shard under TP) transfer workers
                    (``neo-transfer-<s>``) executing swap copy jobs
per-shard-callback  the ``neo-hostshard`` pool under gather-TP: one host
                    attention job per shard per layer (``_host_shard_layer``)
                    and the prefix partials of a shard (``shard_partials``)
host-attn-worker    ``HostAttention``'s own pool (``host_threads > 1``):
                    one row's attention per job (``run_layer``'s ``work``)
host-callback       no seed: the port has no ``io_callback``; its
                    host-prefix callback (``_host_prefix_cb``) runs on its
                    caller's thread and carries that caller's roles
                    (``# repro-role: engine, lane``)
==================  ========================================================

The JAX package's own table (:data:`REFERENCE`, kept verbatim so the
analyzer reproduces the reference's findings over its tree) names its
``io_callback`` bodies and jit memo caches instead.

The checker seeds those roles on the thread entry points below (plus any
``# repro-role:`` comment on a ``def`` line), propagates them through the
heuristic call graph (cross-thread handoffs like ``pool.submit`` do NOT
propagate — that is the role boundary), and then audits shared state:
any ``self.X`` written under one role and read under another must be
lock-protected at both sites or listed in the profile's whitelist with
a documented handoff.  ``__init__`` writes are construction-time and
excluded (thread creation is the happens-before edge).

A small lock-order pass rides along: nested ``with ...lock`` scopes (plus
one level of calls made while holding a lock) form a digraph that must
stay acyclic.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Set, Tuple

from .graph import Access, FuncInfo, FunctionIndex
from .lint import Finding, Module, ProjectRule

__all__ = [
    "RoleChecker", "LockOrder", "Profile", "PORT", "REFERENCE", "PROFILES",
    "ROLE_SEEDS", "SHARED_STATE_WHITELIST", "ROLE_SCOPE",
]


@dataclass(frozen=True)
class Profile:
    """One tree's role map: ``seeds`` (role -> entry-point patterns) and
    ``whitelist`` ((Class, attr) -> documented handoff)."""

    name: str
    seeds: Mapping[str, Tuple[str, ...]]
    whitelist: Mapping[Tuple[str, str], str]


# The roles span the engine core and the observability layer; serving-sim /
# launch / model / benchmark / example code is single-threaded from the
# engine's point of view.
ROLE_SCOPE = ("core/", "obs/")


def _scope(modules: Sequence[Module]) -> List[Module]:
    return [m for m in modules
            if any(m.relpath.startswith(d) for d in ROLE_SCOPE)]


# Entry-point → role map of the port.  Patterns match FuncInfo.shortname;
# ``Class.*`` matches direct methods only, ``Class.m.<locals>.*`` matches
# the closures defined inside ``m`` (which is how work is shipped to pools
# and queues).
ROLE_SEEDS: Dict[str, Tuple[str, ...]] = {
    "engine": (
        # every public/stepping method of the engine runs on the caller's
        # thread, as do the executor/transfer methods it calls inline —
        # those inherit "engine" through call-graph propagation.
        "NeoEngine.*",
        # methods the engine thread calls whose names are on the call
        # graph's stoplist (``decode`` for bytes.decode, ``acquire`` and
        # ``insert`` for locks and lists), so no call resolves to them: the
        # executors' decode passes (batch-0, serial, verify; under
        # gather-TP the shard jobs' submitter) and the prefix cache's
        # acquire/insert would go unaudited without these seeds
        "PagedExecutor.decode",
        "ContiguousExecutor.decode",
        "PrefixCache.acquire",
        "PrefixCache.insert",
    ),
    "planner": (
        # the closure submitted to the neo-planner pool
        "NeoEngine._launch_planahead.<locals>.*",
    ),
    "lane": (
        # run_lane, submitted to the neo-hostlane pool
        "PagedExecutor.submit_host_lane.<locals>.*",
        # the neo-hostprefix thread's host leg of a mixed cached prefill
        # (the cached-prefix host prefill runs as `lane` there, as in the
        # reference; called inline it inherits `engine`)
        "PagedExecutor._prefill_cached.<locals>.host_leg",
    ),
    "copy-stream": (
        # the worker loop; the copy/gather job closures it dequeues carry
        # `# repro-role: copy-stream` annotations at their defs (swap_in's
        # `apply` closure runs engine-side at join time, so a closure glob
        # here would mis-role it)
        "TransferEngine._run",
    ),
    "per-shard-callback": (
        # jobs on the neo-hostshard pool (gather-TP): a shard's host
        # attention for one layer, and a shard's prefix partials
        "PagedExecutor._host_shard_layer",
        "PagedExecutor._host_prefix_cb_tp.<locals>.shard_partials",
    ),
    "host-attn-worker": (
        # one row's attention on HostAttention's own pool (host_threads > 1;
        # called inline with one thread it inherits its caller's roles)
        "HostAttention.run_layer.<locals>.work",
    ),
    # no io_callback in the port: _host_prefix_cb runs on its caller's
    # thread and is annotated with its callers' roles at its def
    "host-callback": (),
}

# (Class, attr) pairs of the port that ARE touched cross-role without a
# common lock, each with the documented handoff that makes the access
# safe.  Strict mode flags stale entries, so the list cannot rot silently.
SHARED_STATE_WHITELIST: Dict[Tuple[str, str], str] = {
    # --- row-partitioned host pool views ----------------------------------
    ("HostAttention", "pool_k"): (
        "numpy views over the host pool (under gather-TP each shard's "
        "instance views its own kv-head slice, kv_head_slice, so the "
        "neo-hostshard threads write disjoint heads): run_layer appends a "
        "row's new token on the one thread that owns the row this step "
        "(the plan partitions host rows between batch-0 and the lanes), "
        "then attends on that thread or on the host-attn-worker pool, whose "
        "jobs are submitted after the append and joined before run_layer "
        "returns; prefix_partials reads only a hit's prefix pages, which no "
        "append of this step writes (its suffix lands after its partials, "
        "on the same thread); swapped-out pages are read only after the "
        "lane's swap-out join"
    ),
    ("HostAttention", "pool_v"): (
        "same row-partitioned, per-shard-slice protocol as pool_k"
    ),
    # --- stale-read-tolerant planner heuristics ---------------------------
    ("PerfModel", "scale"): (
        "per-stage EMA floats: observe() replaces one dict entry at a time "
        "(a GIL-atomic store) on the engine thread, while the planner may "
        "be reading; a slightly stale scale only shifts the plan "
        "heuristic, and plan-ahead adoption revalidates signatures"
    ),
    ("PerfModel", "spec_accept"): (
        "same stale-read-tolerant EMA protocol as PerfModel.scale (a float "
        "rebound by observe_accept on the engine thread)"
    ),
    # --- per-call snapshots ----------------------------------------------
    ("PoolView", "device_free"): (
        "PoolView is a per-plan snapshot: NeoEngine._pool_view builds a "
        "fresh one for each engine-thread plan, the planner gets its own "
        "predicted view (_build_shadow) — instances are never shared "
        "across roles"
    ),
    ("PoolView", "host_free"): (
        "same per-instance snapshot argument as device_free"
    ),
    # --- TransferEngine teardown state ------------------------------------
    ("TransferEngine", "_closed"): (
        "reject-after-close flag: written only by the idempotent close() "
        "on the engine thread; workers read it to drop late jobs during "
        "teardown, and the queue sentinel (not this flag) is what "
        "terminates the worker loop"
    ),
}

# The JAX package's table, verbatim (``repro/analysis/roles.py``): used
# only to reproduce the reference's findings over its own tree.
REFERENCE_ROLE_SEEDS: Dict[str, Tuple[str, ...]] = {
    "engine": (
        "NeoEngine.*",
    ),
    "planner": (
        "NeoEngine._launch_planahead.<locals>.*",
    ),
    "lane": (
        "PagedExecutor.submit_host_lane.<locals>.*",
        "PagedExecutor._prefill_cached_host",
    ),
    "copy-stream": (
        "TransferEngine._run",
    ),
    "host-callback": (
        "PagedExecutor._host_cb",
        "PagedExecutor._host_prefix_cb",
        "PagedExecutor._host_cb_lane",
        "PagedExecutor._build_decode_lane.<locals>.*",
    ),
    "per-shard-callback": (
        "PagedExecutor._host_cb_tp",
        "PagedExecutor._host_prefix_cb_tp",
    ),
}

REFERENCE_SHARED_STATE_WHITELIST: Dict[Tuple[str, str], str] = {
    # --- launch-then-call handoffs (io_callback operand slots) ------------
    ("PagedExecutor", "_cb_prefix_state"): (
        "engine writes the prefix-callback operands strictly before "
        "dispatching the prefill graph; the io_callback that reads them "
        "runs inside that dispatch, and the engine only resumes after the "
        "graph returns (launch-then-call handoff)"
    ),
    ("PagedExecutor", "_cb_lane_state"): (
        "per-lane slot written by submit_host_lane before the lane future "
        "is submitted; the lane's io_callback reads only its own slot "
        "inside that future (pool.submit is the happens-before edge) and "
        "the slot is not reused until the future is joined"
    ),
    # --- jit compile caches: GIL-atomic memo publish ----------------------
    ("PagedExecutor", "_lane_fns"): (
        "keyed by lane id; a lane id is active on at most one thread at a "
        "time (lane-scoped plans), dict get/set are GIL-atomic, and a "
        "racing duplicate compile would publish an equivalent jitted fn"
    ),
    ("PagedExecutor", "_prefill_fns"): (
        "shape-bucket memo of jitted prefill fns: dict publish is "
        "GIL-atomic and values for a key are interchangeable, so the "
        "worst case is one redundant trace"
    ),
    # --- page-granular single-writer pools --------------------------------
    ("PagePool", "k"): (
        "page-granular ownership: device-pool rebinds happen only in "
        "engine-thread jitted writes; host-pool rows touched by a lane "
        "belong to that lane's row partition, and swapped pages are not "
        "readable until their TransferHandle event fires"
    ),
    ("PagePool", "v"): (
        "same page-granular single-writer protocol as PagePool.k"
    ),
    ("HostAttention", "pool_k"): (
        "numpy views over the host pool: the unsharded and per-shard "
        "callbacks never run in the same serve, per-shard callbacks write "
        "disjoint kv-head slices (kv_head_slice), and append/attend for a "
        "row happen inside one ordered callback chain"
    ),
    ("HostAttention", "pool_v"): (
        "same disjoint per-shard slice protocol as pool_k"
    ),
    # --- stale-read-tolerant planner heuristics ---------------------------
    ("PerfModel", "scale"): (
        "EMA float rebound on the engine thread between steps; the "
        "planner reading a slightly stale scale only shifts the plan "
        "heuristic, and plan-ahead adoption revalidates signatures"
    ),
    ("PerfModel", "spec_accept"): (
        "same stale-read-tolerant EMA protocol as PerfModel.scale"
    ),
    # --- per-call snapshots ----------------------------------------------
    ("PoolView", "device_free"): (
        "PoolView is a per-plan snapshot: the engine plans against a live "
        "view, the planner against its own shadow copy — instances are "
        "never shared across roles"
    ),
    ("PoolView", "host_free"): (
        "same per-instance snapshot argument as device_free"
    ),
    # --- TransferEngine post-join/teardown state --------------------------
    ("TransferEngine", "_closed"): (
        "reject-after-close flag: written only by the idempotent close() "
        "on the engine thread; workers read it to drop late jobs during "
        "teardown, and the queue sentinel (not this flag) is what "
        "terminates the worker loop"
    ),
}

PORT = Profile("port", ROLE_SEEDS, SHARED_STATE_WHITELIST)
REFERENCE = Profile("reference", REFERENCE_ROLE_SEEDS, REFERENCE_SHARED_STATE_WHITELIST)
PROFILES: Dict[str, Profile] = {p.name: p for p in (PORT, REFERENCE)}


class RoleChecker(ProjectRule):
    name = "cross-role-state"
    description = (
        "any self.X written under one thread role and read under another "
        "must be locked at both sites, Event-mediated, or whitelisted "
        "with a documented handoff"
    )

    def __init__(self, profile: Profile = PORT) -> None:
        self.profile = profile
        self.last_roles: Dict[str, Set[str]] = {}

    # -- role propagation ---------------------------------------------------

    def propagate(self, index: FunctionIndex) -> Dict[str, Set[str]]:
        roles: Dict[str, Set[str]] = {q: set() for q in index.functions}
        for role, patterns in self.profile.seeds.items():
            for pat in patterns:
                for qual in index.by_shortname(pat):
                    roles[qual].add(role)
        for qual, info in index.functions.items():
            for role in info.role_comments:
                roles[qual].add(role)
        changed = True
        while changed:
            changed = False
            for qual, info in index.functions.items():
                if not roles[qual]:
                    continue
                for call in info.calls:
                    for callee in index.resolve_call(call, info):
                        missing = roles[qual] - roles[callee]
                        if missing:
                            roles[callee] |= missing
                            changed = True
        return roles

    # -- shared-state audit -------------------------------------------------

    def check_project(self, modules: Sequence[Module]) -> List[Finding]:
        index = FunctionIndex(_scope(modules))
        roles = self.propagate(index)
        self.last_roles = roles
        whitelist = self.profile.whitelist

        # collect per-(class, attr) access sites with their function roles
        sites: Dict[Tuple[str, str], List[Tuple[FuncInfo, Access, Set[str]]]] = {}
        for qual, info in index.functions.items():
            if info.classname is None:
                continue
            fn_roles = roles[qual]
            if not fn_roles:
                continue  # unreached from any seeded entry point
            if info.shortname.endswith("__init__") and "<locals>" not in info.shortname:
                continue  # construction-time writes happen before threads
            for acc in info.accesses:
                sites.setdefault((info.classname, acc.attr), []).append(
                    (info, acc, fn_roles))

        out: List[Finding] = []
        used_whitelist: Set[Tuple[str, str]] = set()
        for key in sorted(sites):
            entries = sites[key]
            writes = [e for e in entries if e[1].is_write]
            if not writes:
                continue
            all_roles: Set[str] = set()
            for _, _, r in entries:
                all_roles |= r
            if len(all_roles) < 2:
                continue  # single-role state
            unlocked = [e for e in entries if e[1].lock is None]
            if not unlocked:
                continue  # every site holds a lock
            if key in whitelist:
                used_whitelist.add(key)
                continue
            cls, attr = key
            detail = "; ".join(
                f"{'write' if a.is_write else 'read'}@"
                f"{i.module.relpath}:{a.line} [{'/'.join(sorted(r))}]"
                f"{' unlocked' if a.lock is None else f' lock={a.lock}'}"
                for i, a, r in entries[:6]
            )
            more = f" (+{len(entries) - 6} more sites)" if len(entries) > 6 else ""
            out.append(Finding(
                self.name, writes[0][0].module.relpath, writes[0][1].line,
                f"`{cls}.{attr}` is written under one role and touched "
                f"under others ({'/'.join(sorted(all_roles))}) with "
                f"unlocked sites — lock both sides, mediate with an "
                f"Event, or whitelist with a documented handoff. "
                f"Sites: {detail}{more}",
            ))

        # stale whitelist entries can hide future regressions
        for key in sorted(set(whitelist) - used_whitelist):
            if not any(key[0] == info.classname for info in index.functions.values()):
                continue  # class not in the analyzed module set (tests)
            out.append(Finding(
                self.name, "analysis/roles.py", 1,
                f"whitelist entry `{key[0]}.{key[1]}` no longer matches a "
                "cross-role unlocked access — delete the stale exemption",
            ))
        return out


class LockOrder(ProjectRule):
    name = "lock-order"
    description = (
        "the lock-acquisition digraph (nested `with ...lock` scopes plus "
        "one call level) must stay acyclic"
    )

    def check_project(self, modules: Sequence[Module]) -> List[Finding]:
        index = FunctionIndex(_scope(modules))
        edges: Dict[str, Set[str]] = {}
        where: Dict[Tuple[str, str], Tuple[str, int]] = {}

        def add(a: str, b: str, relpath: str, line: int) -> None:
            if a == b:
                return
            edges.setdefault(a, set()).add(b)
            where.setdefault((a, b), (relpath, line))

        for qual, info in index.functions.items():
            for a, b, line in info.lock_edges:
                add(a, b, info.module.relpath, line)
            # one interprocedural level: call made while holding a lock,
            # into a function that acquires its own top-level lock
            for held, call in info.calls_under_lock:
                for callee in index.resolve_call(call, info):
                    for acquired, line in index.functions[callee].acquired_locks:
                        add(held, acquired,
                            index.functions[callee].module.relpath, line)

        out: List[Finding] = []
        seen_cycles: Set[Tuple[str, ...]] = set()
        for start in sorted(edges):
            cycle = _find_cycle(start, edges)
            if cycle is None:
                continue
            canon = tuple(sorted(cycle))
            if canon in seen_cycles:
                continue
            seen_cycles.add(canon)
            relpath, line = where.get((cycle[0], cycle[1]), ("<project>", 1))
            out.append(Finding(
                self.name, relpath, line,
                "lock-order cycle: " + " -> ".join(cycle + (cycle[0],)),
            ))
        return out


def _find_cycle(start: str, edges: Dict[str, Set[str]]) -> Optional[Tuple[str, ...]]:
    path: List[str] = []
    on_path: Set[str] = set()
    done: Set[str] = set()

    def dfs(node: str) -> Optional[Tuple[str, ...]]:
        if node in on_path:
            i = path.index(node)
            return tuple(path[i:])
        if node in done:
            return None
        path.append(node)
        on_path.add(node)
        for nxt in sorted(edges.get(node, ())):
            found = dfs(nxt)
            if found is not None:
                return found
        path.pop()
        on_path.discard(node)
        done.add(node)
        return None

    return dfs(start)
