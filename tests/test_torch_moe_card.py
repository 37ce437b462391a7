"""The moe, vlm and audio paths' numbers on the card, bf16 at full width.

* Bucket invariance of deepseek-moe-16b's decode step: decode passes pad
  their rows to the reference's bucket (8, 16, 32, 64), and a moe layer runs
  its experts as batched matmuls ``[64, M, 2048] x [64, 2048, 1408]`` and
  back, the shared experts (d_ff 2,816) and ``dense0`` (d_ff 10,944: its
  ``w_down`` has K = 10,944) as plain GEMMs.  Called at the bucket's row
  count, cuBLAS moves a row's bf16 output between buckets (``dense0`` from
  16 rows, the experts at 64; recorded, not asserted), so the executor runs
  the row-wise work in slices of exactly ``ROW_SLICE`` rows
  (``core/executor.py::_in_row_slices``).  Through that path a row's
  projections, post-attention half (``PagedExecutor._layer_post``: output
  projection and FFN) and logits must be bitwise the same in buckets 8-128,
  on a full-width model cut to its first two layers (``dense0`` and one moe
  layer), before ``chip_smoke.py`` may assert pipelined = serial on
  deepseek.  ``-s`` prints one ``moe_bucket_invariance`` JSON line.
* K1 (paged decode) and K2 (flash prefill) against their plain versions at
  the shapes these paths hand them: one query head per KV head (deepseek,
  hd 128), seven (internvl2-1b, hd 64), and seamless's non-causal encoder
  attention over 1,024 frames (16 heads, hd 64), in fp32 and bf16 (2e-3 /
  2e-2).

The tests carry the ``cuda`` marker and skip without a card.  No JAX here:
the card's machine has none.
"""

import functools
import json
import random
import types

import pytest

torch = pytest.importorskip("torch")

from repro_torch.testing import one_thread  # noqa: E402,F401
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.executor import PagedExecutor, _in_row_slices  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.transformer import mlp_apply  # noqa: E402

BUCKETS = (8, 16, 32, 64, 128)
TOL = {"float32": 2e-3, "bfloat16": 2e-2}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the bf16 GEMMs and kernels of the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_moe_decode_rows_bitwise_across_buckets(card):
    cfg = get_config("deepseek-moe-16b").replace(num_layers=2)  # dense0 + one moe layer
    model = get_model(cfg, device=card).init(torch.Generator(device=card).manual_seed(0))
    assert [b.kind for b in model.layers] == ["dense0", "moe"]
    ex = types.SimpleNamespace(cfg=cfg)  # _layer_pre / _layer_post read only the config
    g = torch.Generator(device=card).manual_seed(1)
    bf16 = torch.bfloat16
    row_x = torch.randn(cfg.d_model, generator=g, device=card).to(bf16)
    row_o = torch.randn(cfg.num_heads, cfg.head_dim, generator=g, device=card).to(bf16)
    outs, raw = {}, {}
    with torch.inference_mode():
        for D in BUCKETS:
            x = torch.randn(D, cfg.d_model, generator=g, device=card).to(bf16)
            o = torch.randn(D, cfg.num_heads, cfg.head_dim, generator=g, device=card).to(bf16)
            pos = torch.randint(0, 4096, (D,), generator=g, device=card)
            r = D // 2
            x[r], o[r], pos[r] = row_x, row_o, 777
            got = {"logits": _in_row_slices(model.final_logits, x)[r]}
            for blk in model.layers:
                q, k, v = _in_row_slices(functools.partial(PagedExecutor._layer_pre, ex, blk),
                                         x, pos)
                got[f"{blk.kind}.qkv"] = torch.cat([q[r].flatten(), k[r].flatten(),
                                                    v[r].flatten()])
                got[f"{blk.kind}.post"] = _in_row_slices(
                    functools.partial(PagedExecutor._layer_post, ex, blk), x, o)[r]
                raw[(blk.kind, D)] = mlp_apply(blk, x)[r].clone()
            outs[D] = {k: t.clone() for k, t in got.items()}
    record, failed = {}, []
    for D in BUCKETS[1:]:
        for name, t in outs[D].items():
            same = bool(torch.equal(t, outs[BUCKETS[0]][name]))
            record[f"{name}@{D}"] = same
            if not same:
                failed.append(f"{name}@{D}")
        for kind in ("dense0", "moe"):  # the FFN called at the bucket's own row count
            record[f"{kind}.ffn_unsliced@{D}"] = bool(torch.equal(raw[(kind, D)],
                                                                  raw[(kind, BUCKETS[0])]))
    print(json.dumps({"moe_bucket_invariance": record, "card": torch.cuda.get_device_name(0)}))
    assert not failed, f"a row's bf16 output moved with the bucket: {failed}"


def _k1_case(card, B, H, KV, hd, lens, dtype, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    page = 16
    maxp = max(-(-n // page) for n in lens)
    P = B * maxp + 1
    q = torch.randn(B, H, hd, generator=g, device=card).to(dtype)
    kp = torch.randn(P, page, KV, hd, generator=g, device=card).to(dtype)
    vp = torch.randn(P, page, KV, hd, generator=g, device=card).to(dtype)
    bt = torch.randperm(P, generator=g, device=card)[: B * maxp].reshape(B, maxp)
    return q, kp, vp, bt.to(torch.int32).contiguous(), torch.tensor(lens, dtype=torch.int32,
                                                                      device=card)


@pytest.mark.cuda
@pytest.mark.parametrize("dt_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,H,KV,hd", [("deepseek-moe-16b", 16, 16, 128),
                                          ("internvl2-1b", 14, 2, 64)])
def test_paged_decode_at_new_shapes(card, arch, H, KV, hd, dt_name):
    from repro_torch.kernels.paged_decode.ops import paged_decode_attention
    from repro_torch.kernels.paged_decode.ref import paged_decode_ref

    rng = random.Random(H)
    lens = [rng.randint(256, 528) for _ in range(8)]
    q, kp, vp, bt, ln = _k1_case(card, 8, H, KV, hd, lens, getattr(torch, dt_name), seed=KV)
    got = paged_decode_attention(q, kp, vp, bt, ln)
    want = paged_decode_ref(q, kp, vp, bt, ln)
    tol = TOL[dt_name]
    err = (got.float() - want.float()).abs()
    assert bool((err <= tol + tol * want.float().abs()).all()), (arch, float(err.max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dt_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [
    dict(B=8, S=512, H=16, KV=16, hd=128, causal=True),  # deepseek-moe-16b
    dict(B=8, S=512, H=14, KV=2, hd=64, causal=True),  # internvl2-1b
    dict(B=1, S=1024, H=16, KV=16, hd=64, causal=False),  # seamless encoder
    dict(B=1, S=256, H=16, KV=16, hd=64, causal=True),  # seamless decoder
], ids=["deepseek", "internvl2", "seamless-encoder", "seamless-decoder"])
def test_flash_prefill_at_new_shapes(card, case, dt_name):
    from repro_torch.kernels.flash_prefill.ops import flash_prefill
    from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref

    g = torch.Generator(device=card).manual_seed(case["S"] + case["H"])
    dtype = getattr(torch, dt_name)
    q, k, v = (torch.randn(case["B"], case["S"], n, case["hd"], generator=g,
                           device=card).to(dtype) for n in (case["H"], case["KV"], case["KV"]))
    got = flash_prefill(q, k, v, causal=case["causal"])
    want = flash_prefill_ref(q, k, v, causal=case["causal"])
    tol = TOL[dt_name]
    err = (got.float() - want.float()).abs()
    assert bool((err <= tol + tol * want.float().abs()).all()), (case, float(err.max()))
