"""The port's dry run (``repro_torch.launch.{cells,dryrun}``) and roofline
table (``repro_torch.benchmarks.roofline_table``) against the JAX
package's.

* Every arch x ``shapes_for_arch`` x both production meshes: every input,
  parameter, optimizer-state and cache spec (shape, dtype, partition spec)
  leaf for leaf, ``resident_bytes_per_chip`` and ``default_grad_accum``
  exactly the reference's ``build_cell``'s (one subprocess with 512 fake
  XLA devices).  The port's parameters are per layer where the reference
  stacks a leaf over its layers (``models.bridge.reference_leaves``): each
  port leaf is the reference leaf without its stacked dims, which the
  reference never shards.
* ``build_cell`` turns sequence parallelism on for train cells only (the
  reference's ``test_seq_parallel_rules_only_for_train``).
* The CLI writes an artifact with the reference's keys (a smoke config on
  fake CPU tensors on the fake 16 x 16 world); ``roofline_table``'s
  markdown equals the reference's on the same rows.
* The checked-in artifacts cover every cell on both meshes, each within
  the H100's 80 GB and on its constants (skipped while
  ``experiments/dryrun_torch/`` is absent).
"""

from __future__ import annotations

import glob
import json
import os

import pytest
import torch.distributed as dist

from repro_torch.config import SHAPES_BY_NAME, shapes_for_arch
from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config
from repro_torch.distributed.sharding import StubMesh
from repro_torch.launch.cells import build_cell, default_grad_accum
from repro_torch.models.api import get_model
from repro_torch.models.bridge import reference_leaves
from repro_torch.testing import one_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
ARTIFACTS = os.path.join(HERE, "..", "experiments", "dryrun_torch")
MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}
HBM_BYTES = 80e9  # one H100 SXM
REFERENCE_KEYS = {"arch", "shape", "mesh", "chips", "kind", "ok", "lower_s", "compile_s",
                  "resident_bytes_per_chip", "memory_analysis", "cost_analysis_raw",
                  "hlo_flops_per_chip", "hlo_traffic_upper_bound", "structural_bytes",
                  "grad_accum", "collectives", "roofline"}

_REF_CELLS = """
import json, numpy as np, jax
from jax.sharding import Mesh
from repro.config import SHAPES_BY_NAME, shapes_for_arch
from repro.configs import ARCH_NAMES, get_config
from repro.launch.cells import build_cell, default_grad_accum
from repro.launch.mesh import make_production_mesh

def spec(s, nd):
    parts = list(s) + [None] * (nd - len(s))
    return [(p[0] if len(p) == 1 else list(p)) if isinstance(p, tuple) else p for p in parts]

def key(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)

out = {}
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi)
    mname = "2x16x16" if multi else "16x16"
    for arch in ARCH_NAMES:
        cfg = get_config(arch)
        for shape in shapes_for_arch(cfg):
            cell = build_cell(cfg, shape, mesh)
            structs = jax.tree_util.tree_flatten_with_path(cell.args_structs)[0]
            shards = jax.tree.leaves(cell.in_shardings,
                                     is_leaf=lambda x: isinstance(x, jax.sharding.Sharding))
            out[f"{arch}|{shape.name}|{mname}"] = {
                "leaves": {key(p): [list(s.shape), str(s.dtype), spec(sh.spec, len(s.shape))]
                           for (p, s), sh in zip(structs, shards)},
                "resident": cell.resident_bytes_per_chip(),
                "accum": default_grad_accum(cfg, shape, mesh)}
mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
seq = {k: (build_cell(get_config("qwen3-0.6b"), SHAPES_BY_NAME[k], mesh).rule_overrides
           or {}).get("seq") for k in ("train_4k", "prefill_32k", "decode_32k")}
print(json.dumps({"cells": out, "seq": seq}))
"""


@pytest.fixture(scope="module")
def reference():
    from tests.conftest import run_subprocess

    return json.loads(run_subprocess(_REF_CELLS, devices=512).strip().splitlines()[-1])


@pytest.fixture(scope="module", autouse=True)
def no_world_left():
    """The CLI test starts a fake process group: destroy it after the
    module, so that no later test in this worker finds one running."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _spec(spec, nd):
    parts = list(spec) + [None] * (nd - len(spec))
    return [(p[0] if len(p) == 1 else list(p)) if isinstance(p, tuple) else p for p in parts]


def _leaf(struct, spec):
    return [list(struct.shape), str(struct.dtype).split(".")[-1],
            _spec(spec, len(struct.shape))]


def _port_leaf(cell, path, groups):
    """The port's leaves that hold the reference leaf at ``path`` (a
    "/"-joined key of the reference's args tree): [(port leaf, number of
    the reference's stacked dims)]."""
    top, *rest = path.split("/")
    structs, specs = cell.args_structs[int(top)], cell.in_shardings[int(top)]
    if int(top) == 0 or (cell.kind == "train" and int(top) == 1):
        sub = None
        if int(top) == 1:
            moment, *rest = rest
            structs, specs = structs[moment], specs[moment]
            if rest[-1] in ("row", "col") and tuple(rest[:-1]) in groups:
                *rest, sub = rest
        lead, names = groups[tuple(rest)]
        out = []
        for n in names:
            st, sp = structs[n], specs[n]
            if sub:
                st, sp = st[sub], sp[sub]
            out.append((_leaf(st, sp), len(lead)))
        return out
    if rest:
        structs, specs = structs[rest[0]], specs[rest[0]]
    return [(_leaf(structs, specs), 0)]


def test_cells_equal_reference(reference):
    """Every leaf's shape, dtype and spec, the resident bytes and the
    micro-batch count of every cell on both meshes."""
    n_cells = n_leaves = 0
    for mesh_name, (names, sizes) in MESHES.items():
        mesh = StubMesh(names, sizes)
        for arch in ARCH_NAMES:
            cfg = get_config(arch)
            model = get_model(cfg, device="meta")
            groups = {tuple(p): (lead, g)
                      for p, lead, g in reference_leaves(dict(model.named_parameters()), cfg)}
            for shape in shapes_for_arch(cfg):
                want = reference["cells"][f"{arch}|{shape.name}|{mesh_name}"]
                cell = build_cell(cfg, shape, mesh)
                where = (arch, shape.name, mesh_name)
                assert cell.resident_bytes_per_chip() == want["resident"], where
                assert default_grad_accum(cfg, shape, mesh) == want["accum"], where
                for path, (shp, dt, spec) in want["leaves"].items():
                    for got, lead in _port_leaf(cell, path, groups):
                        assert spec[:lead] == [None] * lead, (where, path)
                        assert got == [shp[lead:], dt, spec[lead:]], (where, path, got)
                        n_leaves += 1
                n_cells += 1
    assert n_cells == 2 * (3 * len(ARCH_NAMES) + 2)
    assert n_leaves > 10_000


def test_seq_parallel_rules_only_for_train(reference):
    mesh = StubMesh(("data", "model"), (2, 4))
    cfg = get_config("qwen3-0.6b")
    got = {k: (build_cell(cfg, SHAPES_BY_NAME[k], mesh).rule_overrides or {}).get("seq")
           for k in ("train_4k", "prefill_32k", "decode_32k")}
    assert got == reference["seq"] == {"train_4k": "model", "prefill_32k": None,
                                       "decode_32k": None}


def test_cli_writes_reference_keys(tmp_path, capsys, monkeypatch):
    """One cell through the CLI on fake CPU tensors: qwen3-0.6b's smoke config
    (the CLI's config lookup patched to it) decoding over a 32k cache on the
    fake 256-rank world."""
    from repro_torch.launch import dryrun

    monkeypatch.setattr(dryrun, "get_config", get_smoke_config)
    assert dryrun.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k", "--device", "cpu",
                        "--out", str(tmp_path)]) == 0
    art = json.loads((tmp_path / "qwen3-0.6b__decode_32k__16x16.json").read_text())
    assert set(art) == REFERENCE_KEYS
    assert art["ok"] and art["chips"] == 256 and art["kind"] == "decode"
    cell = build_cell(get_smoke_config("qwen3-0.6b"), SHAPES_BY_NAME["decode_32k"],
                      StubMesh(*MESHES["16x16"]))
    assert art["resident_bytes_per_chip"] == cell.resident_bytes_per_chip()
    r = art["roofline"]
    assert r["t_compute_s"] == art["hlo_flops_per_chip"] / 989e12
    assert r["t_memory_s"] == art["structural_bytes"]["total"] / 3.35e12
    assert art["hlo_flops_per_chip"] > 0 and art["collectives"]["all-reduce_count"] > 0
    assert "[dryrun] qwen3-0.6b × decode_32k × 16x16: OK" in capsys.readouterr().out


def _rows():
    base = {"kind": "decode", "compile_s": 1.5, "resident_bytes_per_chip": 2.5e9,
            "memory_analysis": {"temp_size_in_bytes": 1.25e9},
            "collectives": {"wire_GB": 0.0125, "all-reduce_count": 306, "all-gather_count": 56},
            "roofline": {"t_compute_s": 6.6e-06, "t_memory_s": 5.8e-4, "t_collective_s": 2.5,
                         "bottleneck": "collective", "useful_flops_ratio": 0.0909,
                         "roofline_fraction": 0.001}}
    for mesh in ("16x16", "2x16x16"):
        for arch, shape in (("qwen3-0.6b", "decode_32k"), ("zamba2-7b", "long_500k"),
                            ("qwen3-0.6b", "train_4k")):
            yield {**base, "arch": arch, "shape": shape, "mesh": mesh}


def test_roofline_table_equals_reference(tmp_path, monkeypatch, capsys):
    from benchmarks import roofline_table as ref
    from repro_torch.benchmarks import roofline_table as port

    for r in _rows():
        (tmp_path / f"{r['arch']}__{r['shape']}__{r['mesh']}.json").write_text(json.dumps(r))
    for mod in (ref, port):
        monkeypatch.setattr(mod, "DRYRUN_DIR", str(tmp_path))
    for mesh in ("16x16", "2x16x16"):
        assert port.dryrun_markdown(mesh) == ref.dryrun_markdown(mesh)
        assert port.roofline_markdown(mesh) == ref.roofline_markdown(mesh)
    ref.main()
    want = capsys.readouterr().out
    port.main()
    assert capsys.readouterr().out == want
    assert "## Dry-run (2x16x16, 3 cells)" in want


def test_dryrun_artifacts_complete():
    """The checked-in artifacts cover every cell on both meshes, each fits
    one H100's 80 GB and reads the H100's constants."""
    if not os.path.isdir(ARTIFACTS):
        pytest.skip("dry-run artifacts not generated yet")
    for mesh in ("16x16", "2x16x16"):
        for arch in ARCH_NAMES:
            for shape in shapes_for_arch(get_config(arch)):
                path = os.path.join(ARTIFACTS, f"{arch}__{shape.name}__{mesh}.json")
                assert os.path.exists(path), f"missing {path}"
                with open(path) as f:
                    art = json.load(f)
                assert art["ok"]
                assert art["chips"] == (512 if mesh == "2x16x16" else 256)
                r = art["roofline"]
                assert r["bottleneck"] in ("compute", "memory", "collective")
                assert r["t_compute_s"] == art["hlo_flops_per_chip"] / 989e12
                assert art["resident_bytes_per_chip"] < HBM_BYTES, \
                    f"{arch}/{shape.name}/{mesh} resident over 80 GB/chip"
    assert len(glob.glob(os.path.join(ARTIFACTS, "*.json"))) >= 2 * (3 * len(ARCH_NAMES) + 2)
