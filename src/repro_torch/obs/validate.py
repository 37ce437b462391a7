"""Validate an exported Chrome trace-event JSON (the CI trace-smoke gate; the
port's copy of the JAX package's ``obs/validate.py``, same checks).

Checks the structural contract the instrumentation promises — the file is
valid Perfetto-loadable JSON, every span's thread row is named, every
track (including the per-shard ``hostattn-*-s<N>`` rows under TP) is
single-writer well-formed (spans nest or are disjoint), the lane /
planner / request timelines are populated, speculative plans were actually
adopted, and (optionally) the copy streams carried traffic:

  PYTHONPATH=src python -m repro_torch.obs.validate trace.json \
      --expect-host-lane --min-adopts 1 [--expect-copy]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict


def validate(path: str, *, expect_host_lane: bool = False,
             expect_copy: bool = False, min_adopts: int = 0) -> list:
    """Returns a list of failure strings (empty == valid)."""
    fails = []
    with open(path) as f:
        doc = json.load(f)
    evs = doc.get("traceEvents", [])
    if not evs:
        return [f"{path}: no traceEvents"]
    if doc.get("otherData", {}).get("events_dropped", 0) > 0:
        fails.append("ring dropped events — timeline is truncated")

    tid_names: Dict[int, str] = {
        e["tid"]: e["args"]["name"] for e in evs
        if e.get("ph") == "M" and e.get("name") == "thread_name"}
    spans_per_track: Dict[str, int] = {}
    track_spans: Dict[str, list] = {}
    for e in evs:
        if e.get("ph") != "X":
            continue
        if e["tid"] not in tid_names:
            fails.append(f"span {e['name']!r} on unnamed tid {e['tid']}")
            continue
        if "ts" not in e or "dur" not in e or e["dur"] < 0:
            fails.append(f"malformed span {e['name']!r}")
        track = tid_names[e["tid"]]
        spans_per_track[track] = spans_per_track.get(track, 0) + 1
        track_spans.setdefault(track, []).append(
            (e["ts"], e["ts"] + e.get("dur", 0), e["name"]))

    # Single-writer well-formedness: within any one track the spans must
    # nest or be disjoint.  Two overlapping-but-not-nested spans mean two
    # writers shared a track — under TP that is exactly the bug of two
    # shard callbacks emitting onto one `hostattn-*-s<N>` row instead of
    # their own per-shard rows (PR-8's open item), so per-shard tracks
    # get the same check as every unsharded track.
    for track, spans in sorted(track_spans.items()):
        bad = _overlap_violation(spans)
        if bad is not None:
            (a0, a1, an), (b0, b1, bn) = bad
            fails.append(
                f"track {track!r} is not single-writer: span {an!r} "
                f"[{a0},{a1}] overlaps {bn!r} [{b0},{b1}] without nesting")

    # every named lane-style track must actually carry spans
    for tid, track in tid_names.items():
        if spans_per_track.get(track, 0) == 0:
            fails.append(f"track {track!r} has no spans")
    if spans_per_track.get("device", 0) == 0 and not any(
            t.startswith("host") and not t.startswith("hostattn")
            for t in spans_per_track):
        fails.append("no lane tracks (neither device nor host<k>)")
    if spans_per_track.get("planner", 0) == 0:
        fails.append("no planner-thread spans")
    if expect_host_lane and not any(
            t.startswith("host") and not t.startswith("hostattn")
            for t in spans_per_track):
        fails.append("no host lane tracks (expected >= 1)")
    if expect_copy and not any(t.startswith("copy-")
                               for t in spans_per_track):
        fails.append("no copy-stream tracks (expected >= 1)")

    adopts = sum(1 for e in evs
                 if e.get("ph") == "i" and e.get("name") == "plan_adopt")
    if adopts < min_adopts:
        fails.append(f"only {adopts} adopted-plan instants "
                     f"(expected >= {min_adopts})")

    begun = {e["id"] for e in evs
             if e.get("ph") == "b" and e.get("name") == "req"}
    ended = {e["id"] for e in evs
             if e.get("ph") == "e" and e.get("name") == "req"}
    if not begun:
        fails.append("no request lifecycle events")
    elif begun != ended:
        fails.append(f"unterminated request spans: {sorted(begun - ended)}")

    if not fails:
        print(f"[obs.validate] OK: {len(evs)} events, "
              f"tracks={sorted(spans_per_track)}, adopts={adopts}, "
              f"requests={len(begun)}")
    return fails


def _overlap_violation(spans):
    """First pair of spans in one track that overlap without nesting, or
    None.  Spans are (t0, t1, name); sorted enclosing-first, a stack proves
    nest-or-disjoint exactly like the tracer's own design contract."""
    stack = []
    for t0, t1, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][1] <= t0:
            stack.pop()
        if stack and t1 > stack[-1][1]:
            return (stack[-1], (t0, t1, name))
        stack.append((t0, t1, name))
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("path", help="Chrome trace-event JSON to validate")
    ap.add_argument("--expect-host-lane", action="store_true",
                    help="require >= 1 host lane track with spans")
    ap.add_argument("--expect-copy", action="store_true",
                    help="require >= 1 copy-stream track with spans")
    ap.add_argument("--min-adopts", type=int, default=0,
                    help="minimum adopted speculative-plan instants")
    args = ap.parse_args(argv)
    fails = validate(args.path, expect_host_lane=args.expect_host_lane,
                     expect_copy=args.expect_copy,
                     min_adopts=args.min_adopts)
    for f in fails:
        print(f"[obs.validate] FAIL: {f}")
    return 1 if fails else 0


if __name__ == "__main__":
    raise SystemExit(main())
