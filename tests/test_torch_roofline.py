"""The port's roofline tooling (``repro_torch.roofline.{opcount,structural,
analysis}``) against the JAX package's (``repro.roofline``).

* The counter (``OpCounter``), the port's counterpart of the reference's
  HLO analysis (its tests hold the reference to 1% on a loop of products
  and to 0.6-1.5x on its gradient; the counter is exact): a loop of T = 12
  products of [128, 128] counts 2 N^3 T FLOPs, its gradient 3 x that; an
  all-reduce of f32[1024] over 4 fake ranks 2 x 4096 x 3/4 wire bytes; a
  sharded product on the fake 16 x 16 world global/256 for a (Shard,
  Partial) output and global/16 for (Shard, Replicate); a kernel's custom
  op its ``work``.
* ``structural_bytes``, ``model_flops`` and ``build_report``'s dict (but
  its constants) exactly the reference's for every arch x
  ``shapes_for_arch`` x both production meshes (the reference's numbers
  from one subprocess with 512 fake XLA devices).
* Per-chip FLOPs of qwen3-0.6b's smoke config on a 2 x 4 mesh: train,
  decode and prefill against the reference's
  ``parse_module(...).total_flops()``, prefill's attention apart (on fake
  CPU tensors the plain attention multiplies the whole square, as the
  reference's chunked jnp does; K2 counts the causal half).
* On the card (``-m cuda``): each kernel's custom op on real tensors
  launches the kernel and matches its plain version, and the counter
  counts its ``work``.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Partial, Replicate, Shard, distribute_tensor

from repro_torch.config import SHAPES_BY_NAME, ShapeConfig, shapes_for_arch
from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config
from repro_torch.distributed.sharding import StubMesh
from repro_torch.launch.cells import build_cell, default_grad_accum
from repro_torch.launch.mesh import start_fake_world
from repro_torch.roofline import analysis
from repro_torch.roofline.opcount import CollectiveStats, OpCounter
from repro_torch.roofline.structural import structural_bytes
from repro_torch.testing import one_thread  # noqa: F401

MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}
# the smoke cells: small enough for XLA to compile the reference's quickly
SMOKE_SHAPES = {"train": ShapeConfig("train_smoke", seq_len=128, global_batch=8, kind="train"),
                "prefill": ShapeConfig("prefill_smoke", seq_len=256, global_batch=4,
                                       kind="prefill"),
                "decode": ShapeConfig("decode_smoke", seq_len=256, global_batch=8,
                                      kind="decode")}
# Per-chip FLOPs of the smoke cells against the reference's HLO count.  Both
# count every product exactly (the reference its dots, trip-corrected; the
# counter its matmul-family ops as they run), so the counts are not rounded:
# train and decode agree to the FLOP.  The tolerance covers one product the
# two sides place differently: the port's prefill takes its last position's
# logits once more than the reference's module shows (65,536 FLOPs a chip,
# 0.03% of the cell).
FLOP_RTOL = 1e-3


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------


def test_loop_of_products_counts_exactly():
    N, T = 128, 12
    x = torch.randn(N, N)
    with OpCounter() as c:
        for _ in range(T):
            x = torch.tanh(x @ x)
    assert c.total_flops() == 2 * N ** 3 * T


def test_gradient_of_loop_counts_forward_and_backward():
    N, T = 128, 12
    x = torch.randn(N, N)
    w = torch.randn(N, N, requires_grad=True)
    with OpCounter() as c:
        y = x
        for _ in range(T):
            y = torch.tanh(y @ w)
        y.sum().backward()
    # a forward product and two backward products (dx, dw) per step, but the
    # first step's dx: x needs no gradient
    assert c.total_flops() == 3 * 2 * N ** 3 * T - 2 * N ** 3
    with OpCounter() as c:
        y = x.requires_grad_(True)
        for _ in range(T):
            y = torch.tanh(y @ w)
        y.sum().backward()
    assert c.total_flops() == 3 * 2 * N ** 3 * T


def test_traffic_counts_operands_and_results():
    a, b = torch.randn(64, 32), torch.randn(32, 16)
    with OpCounter() as c:
        y = a @ b  # reads a, b, writes y
        y.t()  # a view: free
        z = y.clone()  # reads y, writes z
        z[:4] = 0.0  # an update of a slice: twice its bytes (the fill and the copy)
    mm = (64 * 32 + 32 * 16 + 64 * 16) * 4
    assert c.total_traffic_bytes() >= mm + 2 * 64 * 16 * 4
    assert c.flops_by_op == {"aten.mm": 2 * 64 * 32 * 16}


def test_memory_tracks_live_storages():
    """The peak counts the storages the counted ops allocate while they
    live: not an input, not a view or an in-place result of one."""
    x = torch.empty(1000)
    with OpCounter() as c:
        y = x * 2  # 4,000 B
        y.view(10, 100).add_(1)  # a view of y, in place: nothing new
        z = y + x  # 4,000 B more: the peak
        del y
        w = z.t() if z.ndim == 2 else z[:10]  # a view: nothing new
        out_live = c.live
    assert c.peak_bytes() == 8000 and out_live == 4000
    del w, z


def test_collective_wire_accounting():
    """The reference's ring accounting: an all-reduce of f32[1024] over 4
    ranks moves 2 x 4096 x 3/4 bytes per rank."""
    start_fake_world(4)
    from torch.distributed import _functional_collectives as funcol

    with OpCounter() as c:
        funcol.all_reduce(torch.ones(1024), "sum", dist.group.WORLD).wait()
    stats = c.collective_stats()
    assert stats.weighted_bytes() == pytest.approx(2 * 4096 * 3 / 4)
    assert stats.count_by_op == {"all-reduce": 1}


@pytest.mark.parametrize("w_placement,want_div", [(Shard(0), 256), (Replicate(), 16)])
def test_sharded_product_counts_per_rank(w_placement, want_div):
    """x [M, K] (Shard(0) over data; over model Shard(1) when w is sharded
    along K) @ w [K, N]: a (Shard, Partial) output counts global/256, a
    (Shard, Replicate) one global/16."""
    from torch.distributed.device_mesh import init_device_mesh

    start_fake_world(256)
    mesh = init_device_mesh("cpu", (16, 16), mesh_dim_names=("data", "model"))
    M, K, N = 4096, 1024, 512
    x_pl = [Shard(0), Shard(1) if isinstance(w_placement, Shard) else Replicate()]
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        x = distribute_tensor(torch.empty(M, K), mesh, x_pl, src_data_rank=None)
        w = distribute_tensor(torch.empty(K, N), mesh, [Replicate(), w_placement],
                              src_data_rank=None)
        with OpCounter() as c:
            y = x @ w
    want_out = [Shard(0), Partial() if isinstance(w_placement, Shard) else Replicate()]
    assert list(y.placements) == want_out
    assert c.total_flops() == 2 * M * K * N / want_div
    assert c.collective_stats().count_by_op == {}


def test_kernel_custom_op_counts_its_work():
    """A kernel's wrapper on meta tensors returns an empty output through
    its custom op, launches nothing, and the counter counts ``work``."""
    from repro_torch.kernels.flash_prefill import ops as flash
    from repro_torch.kernels.mamba2_ssd import ops as ssd
    from repro_torch.kernels.rwkv6_scan import ops as rwkv

    meta = dict(device="meta")
    q = torch.empty(2, 64, 8, 64, dtype=torch.bfloat16, **meta)
    k = torch.empty(2, 64, 2, 64, dtype=torch.bfloat16, **meta)
    before = flash.flash_prefill.launches
    with OpCounter() as c:
        o = flash.flash_prefill(q, k, k)
    assert o.shape == q.shape and o.device.type == "meta"
    assert flash.flash_prefill.launches == before
    nbytes, flops = flash.work(q, k, k, True, 0)
    assert flops == 4 * 64 * 2 * 8 * (64 * 65 // 2)
    assert (c.total_traffic_bytes(), c.total_flops()) == (nbytes, flops)

    r = torch.empty(1, 32, 4, 16, **meta)
    u, s0 = torch.empty(4, 16, **meta), torch.empty(1, 4, 16, 16, **meta)
    with OpCounter() as c:
        y, sT = rwkv.rwkv6_scan(r, r, r, r, u, s0)
    assert (y.shape, sT.shape) == (r.shape, s0.shape)
    assert c.total_flops() == 4 * 16 * 16 * 32 * 4
    x = torch.empty(1, 32, 4, 8, **meta)
    args = (x, torch.empty(1, 32, 4, **meta), torch.empty(4, **meta),
            torch.empty(1, 32, 16, **meta), torch.empty(1, 32, 16, **meta),
            torch.empty(4, **meta), torch.empty(1, 4, 16, 8, **meta))
    with OpCounter() as c:
        ssd.mamba2_ssd(*args)
    assert c.total_flops() == 5 * 16 * 8 * 32 * 4


def test_direct_launch_counts_as_its_op():
    """A wrapper's launch on real tensors (``opcount.launch``, which skips
    the custom op's dispatch) counts what the op counts on meta tensors:
    the kernel's ``work`` and none of the ATen ops inside the launch; with
    no counter active it is the call alone."""
    from repro_torch.kernels.flash_prefill import ops as flash
    from repro_torch.roofline.opcount import launch

    def stand_in(q, k, v, causal, window):  # a launch's ATen ops, on the CPU
        return flash.flash_prefill_ref(q, k, v, causal=causal, window=window)

    g = torch.Generator().manual_seed(0)
    q, k = torch.randn(2, 64, 8, 64, generator=g), torch.randn(2, 64, 2, 64, generator=g)
    want = stand_in(q, k, k, True, 0)
    assert torch.equal(launch(flash.OP, stand_in, q, k, k, True, 0), want)
    with OpCounter() as direct:
        got = launch(flash.OP, stand_in, q, k, k, True, 0)
    assert torch.equal(got, want)
    with OpCounter() as traced:
        flash.flash_prefill(*(torch.empty(t.shape, device="meta") for t in (q, k, k)))
    assert (direct.total_traffic_bytes(), direct.total_flops()) == flash.work(q, k, k, True, 0)
    assert (direct.total_traffic_bytes(), direct.total_flops(), direct.flops_by_op) == \
        (traced.total_traffic_bytes(), traced.total_flops(), traced.flops_by_op)


def test_counter_refuses_a_torch_without_its_pauses(monkeypatch):
    """A pause whose method a torch lacks raises (else every DTensor op
    would count at its global shape too), and leaves nothing patched."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    from repro_torch.roofline import opcount

    before = ShardingPropagator._propagate_tensor_meta_non_cached
    monkeypatch.setattr(opcount, "_PAUSED", opcount._PAUSED + (
        ("torch.distributed.tensor._sharding_prop", "ShardingPropagator", "no_such_method",
         False, False),))
    with pytest.raises(RuntimeError, match="no_such_method"):
        with OpCounter():
            pass
    assert ShardingPropagator._propagate_tensor_meta_non_cached is before


# ---------------------------------------------------------------------------
# structural bytes, model FLOPs and the report against the reference
# ---------------------------------------------------------------------------

_REF_TABLES = """
import json, numpy as np, jax
from jax.sharding import Mesh
from repro.config import shapes_for_arch, ShapeConfig
from repro.configs import ARCH_NAMES, get_config
from repro.launch.cells import default_grad_accum
from repro.roofline.analysis import build_report, model_flops
from repro.roofline.hlo import CollectiveStats
from repro.roofline.structural import structural_bytes

class M:
    def __init__(self, names, sizes):
        self.shape = dict(zip(names, sizes))
out = {}
stats = CollectiveStats({"all-reduce": 123456}, {"all-reduce": 7.5e6, "all-gather": 2.5e5},
                        {"all-reduce": 3, "all-gather": 2})
for mesh, (names, sizes) in MESHES.items():
    m = M(names, sizes)
    for arch in ARCH_NAMES:
        cfg = get_config(arch)
        for shape in shapes_for_arch(cfg):
            accum = default_grad_accum(cfg, shape, m) if shape.kind == "train" else 1
            sb = structural_bytes(cfg, shape, m, grad_accum=accum)
            rep = build_report(cfg, shape, mesh, int(np.prod(sizes)), flops_per_chip=1.25e12,
                               bytes_per_chip=sb["total"], collectives=stats,
                               memory_per_chip=3.5e9)
            out[f"{arch}|{shape.name}|{mesh}"] = {
                "accum": accum, "structural": sb, "model_flops": model_flops(cfg, shape),
                "report": rep.to_dict()}

def smoke_flops(kind, shape):
    from repro.configs import get_smoke_config
    from repro.launch.cells import build_cell
    from repro.roofline.hlo import parse_module
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
    cell = build_cell(get_smoke_config("qwen3-0.6b"), shape, mesh)
    return parse_module(cell.lower(mesh).compile().as_text()).total_flops()

smoke = {k: smoke_flops(k, ShapeConfig(*v)) for k, v in SMOKE.items()}
print(json.dumps({"tables": out, "smoke": smoke}))
"""


@pytest.fixture(scope="module")
def reference():
    from tests.conftest import run_subprocess

    smoke = {k: [s.name, s.seq_len, s.global_batch, s.kind] for k, s in SMOKE_SHAPES.items()}
    code = (f"MESHES = {json.dumps({k: [list(n), list(s)] for k, (n, s) in MESHES.items()})}\n"
            f"SMOKE = {json.dumps(smoke)}\n" + _REF_TABLES)
    return json.loads(run_subprocess(code, devices=512).strip().splitlines()[-1])


def _stats():
    return CollectiveStats({"all-reduce": 123456}, {"all-reduce": 7.5e6, "all-gather": 2.5e5},
                           {"all-reduce": 3, "all-gather": 2})


def test_structural_flops_and_report_equal_reference(reference):
    tables = reference["tables"]
    n = 0
    for mesh, (names, sizes) in MESHES.items():
        m = StubMesh(names, sizes)
        for arch in ARCH_NAMES:
            cfg = get_config(arch)
            for shape in shapes_for_arch(cfg):
                want = tables[f"{arch}|{shape.name}|{mesh}"]
                accum = default_grad_accum(cfg, shape, m) if shape.kind == "train" else 1
                assert accum == want["accum"], (arch, shape.name, mesh)
                sb = structural_bytes(cfg, shape, m, grad_accum=accum)
                assert sb == want["structural"], (arch, shape.name, mesh)
                assert analysis.model_flops(cfg, shape) == want["model_flops"]
                rep = analysis.build_report(cfg, shape, mesh, int(np.prod(sizes)),
                                            flops_per_chip=1.25e12, bytes_per_chip=sb["total"],
                                            collectives=_stats(), memory_per_chip=3.5e9)
                got, ref = rep.to_dict(), dict(want["report"])
                # the constants: the H100's in place of the TPU's
                assert got["t_compute_s"] == 1.25e12 / 989e12
                assert got["t_memory_s"] == sb["total"] / 3.35e12
                assert got["t_collective_s"] == (7.5e6 + 2.5e5) / (18 * 25e9)
                for k in ("t_compute_s", "t_memory_s", "t_collective_s", "bottleneck",
                          "roofline_fraction"):
                    got.pop(k), ref.pop(k)
                assert got == ref, (arch, shape.name, mesh)
                n += 1
    assert n == 2 * (3 * len(ARCH_NAMES) + 2)


def test_report_mfu_and_fraction():
    cfg, shape = get_config("qwen3-0.6b"), SHAPES_BY_NAME["decode_32k"]
    rep = analysis.build_report(cfg, shape, "1x1", 1, flops_per_chip=1e9, bytes_per_chip=4e9,
                                collectives=CollectiveStats())
    assert rep.bottleneck == "memory" and rep.t_bound == 4e9 / 3.35e12
    assert rep.mfu(rep.t_bound) == rep.roofline_fraction
    assert rep.mfu(1.0) == analysis.model_flops(cfg, shape) / 989e12


# ---------------------------------------------------------------------------
# per-chip FLOPs of a smoke cell against the reference's HLO count
# ---------------------------------------------------------------------------


def _smoke_counter(kind):
    from torch.distributed.device_mesh import init_device_mesh

    start_fake_world(8)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    cell = build_cell(get_smoke_config("qwen3-0.6b"), SMOKE_SHAPES[kind], mesh)
    return cell.lower(mesh, "cpu")


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_smoke_cell_flops_match_reference(reference, kind):
    got = _smoke_counter(kind).total_flops()
    want = reference["smoke"][kind]
    assert got == pytest.approx(want, rel=FLOP_RTOL), (got, want)


def test_smoke_prefill_flops_apart_from_attention(reference):
    """Prefill on fake CPU tensors runs the plain attention, which multiplies
    the whole [S, S] square per chunk as the reference's chunked jnp does,
    so the whole cell compares.  With fake cuda tensors K2 counts its
    causal half instead (its ``work``): that part alone differs, by
    construction."""
    c = _smoke_counter("prefill")
    assert c.total_flops() == pytest.approx(reference["smoke"]["prefill"], rel=FLOP_RTOL)
    attn = c.flops_by_op["aten.bmm"]  # the plain attention's two products
    cfg, shape = get_smoke_config("qwen3-0.6b"), SMOKE_SHAPES["prefill"]
    S, rows, heads = shape.seq_len, shape.global_batch // 2, cfg.num_heads // 4
    assert attn == cfg.num_layers * 2 * 2 * rows * heads * S * S * cfg.head_dim


def test_extrapolated_train_counts_equal_direct_trace():
    """``lower_extrapolated`` (four small traces, bilinear in layer units and
    micro-batches) against the direct trace of the same cell: zamba2's
    smoke config (two units of 3 Mamba blocks after a shared attention
    application, and a tail of 1; rwkv6's is the same formula with a unit
    of one block and no tail) with 4 micro-batches on a fake 2 x 4 world.
    FLOPs and collectives exactly; the traffic bound and the live-byte peak
    within 0.5%."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.config import TrainConfig
    from repro_torch.launch.cells import lower_extrapolated

    start_fake_world(8)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    cell = build_cell(get_smoke_config("zamba2-7b"), ShapeConfig("train_4k", 16, 16, "train"),
                      mesh, train_cfg=TrainConfig(grad_accum=4))
    direct, ext = cell.lower(mesh, "cpu"), lower_extrapolated(cell, mesh, "cpu")
    assert ext.total_flops() == direct.total_flops()
    assert ext.collective_stats().summary() == direct.collective_stats().summary()
    assert ext.total_traffic_bytes() == pytest.approx(direct.total_traffic_bytes(), rel=5e-3)
    assert ext.peak_bytes() == pytest.approx(direct.peak_bytes(), rel=5e-3)


# ---------------------------------------------------------------------------
# the kernels' custom ops on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs an NVIDIA GPU")
@pytest.mark.parametrize("case", range(8))
def test_custom_ops_launch_kernels_on_the_card(case):
    """The kernel table's cases (``benchmarks.kernels.CASES``): the wrapper
    on real tensors launches the kernel once (directly, skipping the custom
    op's dispatch), the output passes the table's check against the plain
    version, and the counter counts the kernel's ``work``; the custom op
    itself on real tensors launches the kernel too, and passes the same
    check."""
    from repro_torch.benchmarks import kernels as bk
    from repro_torch.kernels.flash_prefill import ops as flash
    from repro_torch.kernels.mamba2_ssd import ops as ssd
    from repro_torch.kernels.paged_decode import ops as paged
    from repro_torch.kernels.rwkv6_scan import ops as rwkv

    name, label, dt_name, make, shape = bk.CASES[case]
    mod = {"flash_prefill": flash, "rwkv6_scan": rwkv, "mamba2_ssd": ssd,
           "paged_decode": paged}[name]
    kern, plain, _ = bk.kernel_fns(name)
    args, _, _ = make("cuda", getattr(torch, dt_name), **shape)
    before = kern.launches
    with OpCounter() as c:
        got = kern(*args)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    bk._check(name, label, dt_name, got, plain(*args))
    assert (c.total_traffic_bytes(), c.total_flops()) == mod.OP_WORK(*args)
    via_op = mod.OP(*args, True, 0) if name == "flash_prefill" else mod.OP(*args)
    torch.cuda.synchronize()
    assert kern.launches == before + 2
    bk._check(name, label, dt_name, via_op, plain(*args))
