"""BENCHMARK.json's shape, names and bounds, every cell's files found
by name, and what the harness and the references load, in subprocesses."""

import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import pytest  # noqa: E402

from bench import harness  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"] and SPEC["command"] == ["python3", "bench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names = [m["name"] for m in metrics] + [c["name"] for c in SPEC["configs"]] + [
        w["name"] for w in SPEC["workloads"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    assert all(0.01 <= m["bound"] <= 0.25 for m in SPEC["end_to_end"])
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in SPEC["end_to_end"])
    cells = {w["name"] for w in SPEC["workloads"]}
    assert all(set(m.get("workloads", cells)) <= cells for m in metrics)
    for cell in cells:  # setup_s, another end-to-end metric, a per-layer one
        assert len(harness.metrics_for(SPEC, cell, False)) >= 2
        assert harness.metrics_for(SPEC, cell, True)
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert all(m["moves"] in e2e and m["layer"] for m in SPEC["per_layer"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_found_by_name(cell):
    c = harness.cell_of(SPEC, cell)
    assert cell == f"{c['config']}.{c['traffic']}" and c["chips"] == 1
    cfg = harness.config_file(c["config"])
    conf = next(x for x in SPEC["configs"] if x["name"] == c["config"])
    assert conf["file"] == f"bench/configs/{c['config']}.json"
    assert conf["source"] == cfg["source"] and conf["reduced"] == cfg["reduced"]
    mix = harness.mix_file(c["traffic"])
    assert mix["rate"] > 0 and mix["first_wave"] > 0 and mix["source"]
    assert hasattr(harness.reference(cfg["family"]), "logits_at")
    for trace in (False, True):
        for m in harness.metrics_for(SPEC, cell, trace):
            assert callable(harness.reader(m["name"]).read)
    assert cfg["limits"]


def _python(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=240)


def test_harness_loads_no_jax_nor_the_jax_package():
    """A whole smoke run on the CPU, then the loaded top-level names."""
    code = f"""
import sys, time, torch
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
torch.set_num_threads(1)
from bench import harness, testing
harness.execute(testing.CELL, testing.dense(), testing.chat(), [], 5, 0.3, False,
                torch.device("cpu"), time.perf_counter())
import bench.run
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""
    out = _python(code)
    assert out.returncode == 0, out.stderr
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}


def test_references_load_nothing_of_the_program():
    code = f"""
import sys, torch
sys.path[:0] = [{str(ROOT)!r}]
from bench import testing, weights
from bench.reference import dense, moe
for ref, cfg in ((dense, testing.dense()), (moe, testing.moe())):
    w = weights.make(ref.weight_groups(cfg), 1, "cpu")
    ref.logits_at(w, cfg, [{{"tokens": torch.arange(1, 20), "want": torch.tensor([18]),
                             "prompt_len": 10, "batch_len": 10}}], quant="fp8")
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""
    out = _python(code)
    assert out.returncode == 0, out.stderr
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_forbidden_names_compare_whole_top_level_names():
    assert harness.forbidden_modules(["repro_torch.core", "jaxtyping", "numpy"]) == []
    assert harness.forbidden_modules(["repro.core", "jax._src", "flax"]) == ["flax", "jax", "repro"]


def test_without_a_card_no_result():
    cell = SPEC["workloads"][0]["name"]
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", cell, "--seed",
                          str(2**31 + 3), "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=240,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""
