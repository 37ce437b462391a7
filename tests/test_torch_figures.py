"""The port's paper-figure drivers (``repro_torch.benchmarks.fig6_load_latency``,
``fig8_fastdecode``, ``fig9_lengths``, ``fig10a_cpu``) against the JAX
package's, its kernel table (``.kernels``) and aggregator (``.run``), on the
CPU.

The figures run the simulator, which in the port returns the reference's
metrics exactly (``tests/test_torch_simulator.py``), so at the same flags
each figure's JSON must equal the reference's.  Both ``main``s run with
``save_json`` replaced, for the test only, by one that captures the dict:
the reference's would write under ``experiments/figures/`` (tracked), and
its file stays untouched.  ``--quick`` with ``--n`` cut to 40 requests (24
for Fig. 6, 20 for Fig. 8), where every setting still offloads part of its
decode.
"""

import json
from pathlib import Path

import pytest

pytest.importorskip("torch")

import benchmarks.fig10a_cpu as ref_fig10a  # noqa: E402
import benchmarks.fig6_load_latency as ref_fig6  # noqa: E402
import benchmarks.fig8_fastdecode as ref_fig8  # noqa: E402
import benchmarks.fig9_lengths as ref_fig9  # noqa: E402
from benchmarks import common as ref_common  # noqa: E402

from repro_torch.testing import one_thread  # noqa: E402,F401
from repro_torch.benchmarks import (common, fig6_load_latency, fig8_fastdecode,  # noqa: E402
                                    fig9_lengths, fig10a_cpu, kernels)
from repro_torch.benchmarks import run as bench_run  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
FIGURES = {
    "fig6_load_latency": (ref_fig6, fig6_load_latency, ["--quick", "--dist", "--n", "24"]),
    "fig8_fastdecode": (ref_fig8, fig8_fastdecode, ["--quick", "--n", "20"]),
    "fig9_lengths": (ref_fig9, fig9_lengths, ["--quick", "--n", "40"]),
    "fig10a_cpu": (ref_fig10a, fig10a_cpu, ["--quick", "--n", "40"]),
}


def _captured(mod, args):
    """``mod.main(args)``'s JSON dict (through a JSON round trip), with
    ``save_json`` capturing instead of writing."""
    saved = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, "save_json", lambda name, data: saved.setdefault(name, data))
        assert mod.main(args) == 0
    (name, data), = saved.items()
    return name, json.loads(json.dumps(data))


@pytest.fixture(scope="module")
def port_figures():
    return {fig: _captured(port_mod, args) for fig, (_, port_mod, args) in FIGURES.items()}


@pytest.mark.parametrize("fig", list(FIGURES))
def test_figure_json_equals_the_references(fig, port_figures):
    ref_mod, _, args = FIGURES[fig]
    name, ref = _captured(ref_mod, args)
    port_name, port = port_figures[fig]
    assert port_name == name == f"{fig}.json"
    assert port == ref


def test_figures_exercise_every_setting(port_figures):
    """At the tested sizes every hardware setting of Fig. 6 and Fig. 9
    offloads part of NEO's decode, and Fig. 10a's instances differ."""
    fig6 = port_figures["fig6_load_latency"][1]
    for label, *_ in common.FIG6_SETTINGS:
        assert any(row[3] > 0 for row in fig6[label]["rows"]), label
    assert {"fig7_neo", "fig7_gpu_only"} <= set(fig6)
    for label, res in port_figures["fig9_lengths"][1].items():
        assert any(row[4] > 0 for row in res["rows"]), label
    fig10a = port_figures["fig10a_cpu"][1]
    assert len({json.dumps(v) for v in fig10a.values()}) > 1


def test_settings_and_paths():
    """FIG6_SETTINGS is the reference's; the port writes under build/
    (git-ignored), never under experiments/figures/."""
    assert common.FIG6_SETTINGS == ref_common.FIG6_SETTINGS
    assert Path(common.FIG_DIR) == REPO / "build" / "figures"
    assert Path(common.FIG_DIR).resolve() != Path(ref_common.FIG_DIR).resolve()


def test_save_json_lands_under_build(monkeypatch, tmp_path):
    monkeypatch.setattr(common, "FIG_DIR", str(tmp_path / "figures"))
    path = common.save_json("x.json", {"a": [1, 2]})
    assert Path(path) == tmp_path / "figures" / "x.json"
    assert json.loads(Path(path).read_text()) == {"a": [1, 2]}


def test_kernel_table_on_the_cpu():
    """On the CPU every kernel's plain version (what the wrapper runs there)
    agrees with the other plain form ``ref.py`` keeps, at the reference
    benchmark's shapes (the main path's are the card's), within the kernels' tolerance
    (``run_table`` raises past it; the scans' of their largest output); the
    bounds are positive and say what binds."""
    rows = kernels.run_table("cpu", labels=("reference",))
    assert [(r["kernel"], r["shape_of"]) for r in rows] == \
        [(c[0], c[1]) for c in kernels.CASES if c[1] == "reference"]
    for r in rows:
        assert r["device"] == "cpu" and "ms" not in r and r["max_abs_err"] >= 0
        assert r["bound_ms"] > 0 and r["bound_by"] in ("bytes", "operations")
        assert r["plain_ms"] > 0


def test_kernel_bounds():
    """The bound helpers ``chip_smoke.py`` shares: bytes once at 3.35 TB/s
    or the operations at the unit's peak, whichever is larger."""
    torch = pytest.importorskip("torch")
    q = torch.zeros(8, 16, 128, dtype=torch.bfloat16)
    ms, by = kernels.bound(q, [512] * 8, 16, 8, 128)
    nbytes = 8 * 512 * 8 * 128 * 2 * 2 + 2 * q.numel() * 2 + 4 * 8 + 4 * 8 * 32
    assert by == "bytes" and ms == pytest.approx(nbytes / kernels.HBM_BYTES_PER_S * 1e3)
    assert kernels.prefill_pairs(4, True, 0) == 10 and kernels.prefill_pairs(4, False, 0) == 16
    assert kernels.prefill_pairs(4, True, 2) == 7
    qf = torch.zeros(1, 4096, 16, 128, dtype=torch.bfloat16)
    kf = torch.zeros(1, 4096, 8, 128, dtype=torch.bfloat16)
    ms, by = kernels.flash_bound(qf, kf, True, 0)
    flops = 4 * 128 * 16 * kernels.prefill_pairs(4096, True, 0)
    assert by == "operations" and ms == pytest.approx(flops / kernels.BF16_FLOPS * 1e3)


def test_run_aggregates_and_reports_failures(monkeypatch, capsys):
    """``run.main`` runs each section once, counts a nonzero return or an
    exception as a failure, and skips the engine sections with
    ``--skip-real``."""
    calls = []

    def ok(name):
        return lambda argv=None: calls.append((name, argv)) or 0

    for mod in (fig6_load_latency, fig8_fastdecode, fig9_lengths, fig10a_cpu):
        monkeypatch.setattr(mod, "main", ok(mod.__name__.rsplit(".", 1)[1]))
    monkeypatch.setattr(kernels, "main", ok("kernels"))
    assert bench_run.main(["--quick", "--skip-real", "--device", "cpu"]) == 0
    assert [c[0] for c in calls] == ["fig6_load_latency", "fig8_fastdecode", "fig9_lengths",
                                     "fig10a_cpu", "kernels"]
    assert calls[0][1] == ["--quick", "--dist"] and calls[-1][1] == ["--device", "cpu"]

    def boom(argv=None):
        raise RuntimeError("no card")

    monkeypatch.setattr(kernels, "main", boom)
    assert bench_run.main(["--quick", "--skip-real"]) == 1
    assert "1 failures" in capsys.readouterr().out
