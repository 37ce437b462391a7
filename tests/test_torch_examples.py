"""The port's examples (``repro_torch.examples``) against the JAX package's
(``examples/*.py``), on the CPU at the reference's smoke config.

Both sides serve the same weights (the reference's ``init`` from the key
its example uses, carried over by ``models/bridge.py``) with the perf model
frozen and the H100 profile: on the reference side the name
``EngineConfig`` in the example's namespace is replaced, for the test only,
by ``EngineConfig`` with ``ewma_alpha=0`` and ``hw_profile="h100_sxm"`` (the
port's default profile); the reference's files stay as they are.
``serve_online`` runs on one virtual clock on both sides (the reference's
``time`` module name is replaced by the clock's ``perf_counter`` and
``sleep``), a reading a second, about the reference's step time on a CPU:
under it ``--n 8 --crash`` replays nothing, as the reference's wall-clock
run did, and ``--n 12 --crash`` replays five requests.  Every printed line
is the reference's, and so are the tokens request by request, the plans
and the recovered count.  Each reference run happens once, in a
module-scoped fixture.
"""

import contextlib
import functools
import importlib.util
import io
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.core.executor  # noqa: E402,F401  (its io_callback patch for one-core hosts)
from repro.config import EngineConfig as RefEngineConfig  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.models.api import get_model as ref_get_model  # noqa: E402

from repro_torch.testing import one_thread  # noqa: E402,F401
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.examples import capacity_planner, quickstart, serve_online  # noqa: E402
from repro_torch.models.bridge import params_from_reference  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
ARCH = "qwen3-0.6b"
TICK = 1.0  # virtual seconds per clock reading
CRASH_N = 12  # --n at which --crash replays requests (the example's default)


def _reference(name):
    """The JAX package's ``examples/<name>.py`` as a module (not a package)."""
    spec = importlib.util.spec_from_file_location(f"ref_example_{name}",
                                                  REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bridged(key):
    """The port's state dict of the reference's ``init(key)`` weights."""
    params = ref_get_model(ref_smoke(ARCH)).init(jax.random.key(key))
    return params_from_reference(jax.tree.map(np.asarray, params), get_smoke_config(ARCH))


FROZEN = functools.partial(RefEngineConfig, ewma_alpha=0.0, hw_profile="h100_sxm")


# ---------------------------------------------------------------------------
# capacity_planner (the simulator: no weights)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [["--n", "40"], ["--n", "40", "--hw", "h100_sxm"]],
                         ids=["t4_g4dn", "h100_sxm"])
def test_capacity_planner_prints_reference_lines(argv, capsys, monkeypatch):
    ref = _reference("capacity_planner")
    monkeypatch.setattr(sys, "argv", ["capacity_planner.py", *argv])
    ref.main()
    want = capsys.readouterr().out
    best = capacity_planner.main([*argv, "--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want
    assert "sustainable load" in got and set(best) == {"gpu_only", "neo"}


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def quickstart_ref():
    """The reference's quickstart (perf model frozen), its stdout and tokens
    by policy."""
    ref = _reference("quickstart")
    engines = []
    real = ref.NeoEngine

    def recording(*a, **k):
        engines.append(real(*a, **k))
        return engines[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref, "EngineConfig", FROZEN)
        mp.setattr(ref, "NeoEngine", recording)
        out, _ = _stdout(ref.main)
    tokens = {e.engine_cfg.policy: {rid: list(r.out_tokens) for rid, r in e.requests.items()}
              for e in engines}
    return out, tokens


def _stdout(fn, *a, **k):
    """(what ``fn(*a, **k)`` printed, its result)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn(*a, **k)
    return buf.getvalue(), res


def test_quickstart_matches_reference(quickstart_ref):
    want_out, want_tokens = quickstart_ref
    state = _bridged(42)
    got_out, res = _stdout(quickstart.main, ["--device", "cpu"], params=state, ewma_alpha=0.0)
    assert got_out == want_out
    assert res["outputs"] == want_tokens and res["same"]
    # the tiny device pool really offloads, and the counters say so
    assert res["stats"]["neo"]["offloaded_decodes"] > 0
    assert "offloaded_decodes=0 " in want_out.splitlines()[0]


# ---------------------------------------------------------------------------
# serve_online --crash on one virtual clock
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def serve_ref():
    """The reference's serve_online --crash at ``--n`` 8 and CRASH_N on the
    virtual clock (perf model frozen): per n its stdout, tokens by prompt,
    plans per engine and recovered count."""
    ref = _reference("serve_online")
    runs = {}
    for n in (8, CRASH_N):
        engines, mapping = [], {}
        real = ref.build_engine

        def recording(cfg, params=None):
            e = real(cfg, params=params)
            replay = e.replay_journal

            def recorded_replay(journal):
                mapping.update(replay(journal))
                return mapping

            e.replay_journal = recorded_replay
            engines.append(e)
            return e

        clk = serve_online.VirtualClock(TICK)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ref, "EngineConfig", FROZEN)
            mp.setattr(ref, "build_engine", recording)
            mp.setattr(ref, "time", types.SimpleNamespace(perf_counter=clk.perf_counter,
                                                           sleep=clk.sleep))
            mp.setattr(sys, "argv", ["serve_online.py", "--n", str(n), "--crash"])
            out, _ = _stdout(ref.main)
        runs[n] = {"out": out, "tokens": serve_online.request_tokens(engines, mapping),
                   "plans": [list(e.stats.plans) for e in engines],
                   "recovered": len(mapping), "engines": len(engines)}
    return runs


@pytest.fixture(scope="module")
def serve_state():
    return _bridged(0)


@pytest.mark.parametrize("n,recovered", [(8, 0), (CRASH_N, 5)], ids=["n8", f"n{CRASH_N}"])
def test_serve_online_crash_matches_reference(serve_ref, serve_state, n, recovered):
    want = serve_ref[n]
    clk = serve_online.VirtualClock(TICK)
    got_out, res = _stdout(serve_online.main, ["--n", str(n), "--crash", "--device", "cpu"],
                           params=serve_state, clock=clk.perf_counter, sleep=clk.sleep,
                           ewma_alpha=0.0)
    assert got_out == want["out"]
    assert res["tokens"] == want["tokens"]
    assert res["plans"] == want["plans"]
    assert res["recovered"] == want["recovered"] == recovered
    assert want["engines"] == 2 and res["crashed"]
    assert len(res["tokens"]) == n and all(len(t) > 0 for t in res["tokens"].values())
    assert f"recovered {recovered} unfinished requests" in got_out


def test_serve_online_crash_keeps_crash_free_tokens(serve_state):
    """The journal replay gives each request the tokens of a run without a
    crash (fp32, smoke width)."""
    runs = {}
    for crash in (False, True):
        clk = serve_online.VirtualClock(TICK)
        argv = ["--n", str(CRASH_N), "--device", "cpu"] + (["--crash"] if crash else [])
        _, runs[crash] = _stdout(serve_online.main, argv, params=serve_state,
                                 clock=clk.perf_counter, sleep=clk.sleep, ewma_alpha=0.0)
    assert runs[True]["recovered"] > 0 and not runs[False]["crashed"]
    assert runs[True]["tokens"] == runs[False]["tokens"]


# ---------------------------------------------------------------------------
# the card unless asked
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mod", [capacity_planner, quickstart, serve_online],
                         ids=["capacity_planner", "quickstart", "serve_online"])
def test_examples_refuse_cpu_unless_asked(mod, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main([])
