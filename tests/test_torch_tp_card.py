"""Gather-TP's pieces on the card, bf16 at full width.

* The column-sharded GEMMs: gather-TP claims greedy decode is bitwise the
  same at any TP degree because every cross-shard combine is a
  concatenation.  The replicated GEMMs (``wo``, ``w_down``, the logits) see
  the shapes of ``tp=1``; the column-sharded ones (QKV, ``w_gate``/``w_up``)
  run at N/tp columns, where cuBLAS may pick another kernel, or another
  split-K, than at N and move a column's bits (qwen3-14b's ``wk``/``wv`` at
  64 rows did).  Each shard's output columns must be bitwise the unsharded
  GEMM's same columns, at the decode slice's M = 64 rows (through
  ``core/executor.py::_shard_rows``, which pads a shard's rows to tp x 64)
  and at a prefill's M (at least ``models/layers.py::PREFILL_MIN_ROWS``
  rows, on both sides), for qwen3-0.6b (K = 1024) at tp 2 and 4 and
  qwen3-14b (K = 5120) at tp 2, through ``project_qkv`` and
  ``swiglu_hidden`` as the executor calls them.  ``-s`` prints one
  ``tp_gemm_bitwise`` JSON line (per GEMM, per M, and each bare GEMM at 64
  rows unpadded) before the assertion; a second test records which other
  forms of the 64-row GEMM keep the columns (``tp_gemm_forms``).
* K1 (paged decode) and K2 (flash prefill) against their plain versions at
  the shard shapes: 8/4 and 4/2 query/KV heads (qwen3-0.6b at tp 2 and 4),
  20/4 (qwen3-14b at tp 2), hd 128, fp32 and bf16 (2e-3 / 2e-2).

The tests carry the ``cuda`` marker and skip without a card.  No JAX here:
the card's machine has none.
"""

import json
import random

import pytest

torch = pytest.importorskip("torch")

from repro_torch.testing import one_thread  # noqa: E402,F401
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.executor import ROW_SLICE, _shard_rows  # noqa: E402
from repro_torch.models.layers import PREFILL_MIN_ROWS, swiglu_hidden  # noqa: E402
from repro_torch.models.transformer import project_qkv  # noqa: E402

TOL = {"float32": 2e-3, "bfloat16": 2e-2}
# prefill rows of short prompts (B x _bucket(S, 16)) and the shard GEMMs
# they meet: (name, K, N, tp degrees), qwen3-0.6b at tp 2 and 4, qwen3-14b
# at tp 2
PREFILL_M = (16, 64, 128, 512)
PREFILL_GEMMS = [("qwen3-0.6b/wq", 1024, 2048, (2, 4)), ("qwen3-0.6b/wk", 1024, 1024, (2, 4)),
                 ("qwen3-0.6b/w_gate", 1024, 3072, (2, 4)),
                 ("qwen3-14b/wq", 5120, 5120, (2,)), ("qwen3-14b/wk", 5120, 1024, (2,)),
                 ("qwen3-14b/w_gate", 5120, 17408, (2,))]
# (arch, tp, prefill rows: the padded prefill batch of chip_smoke's 3g cells)
GEMM_CASES = [("qwen3-0.6b", 2, 8 * 1024), ("qwen3-0.6b", 4, 8 * 1024),
              ("qwen3-14b", 2, 4 * 512)]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the bf16 GEMMs and kernels of the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _weights(cfg, card, g):
    d, H, KV, hd, f = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff
    bf16 = torch.bfloat16
    w = {"wq": torch.randn(d, H, hd, generator=g, device=card) / d ** 0.5,
         "wk": torch.randn(d, KV, hd, generator=g, device=card) / d ** 0.5,
         "wv": torch.randn(d, KV, hd, generator=g, device=card) / d ** 0.5,
         "w_gate": torch.randn(d, f, generator=g, device=card) / d ** 0.5,
         "w_up": torch.randn(d, f, generator=g, device=card) / d ** 0.5}
    w = {k: v.to(bf16) for k, v in w.items()}
    w["q_norm"] = torch.ones(hd, device=card)
    w["k_norm"] = torch.ones(hd, device=card)
    return w


@pytest.mark.cuda
def test_column_sharded_gemms_bitwise(card):
    """Through the executor's forms: a decode slice's shard projections and
    SwiGLU hidden through ``_shard_rows`` (rows padded to tp x 64), a
    prefill's at its own M (the 3g cells' padded batches and the short
    prompts' ``PREFILL_M``) with at least ``PREFILL_MIN_ROWS`` rows on both
    sides; each bare GEMM at 64 rows unpadded is recorded beside them."""
    record, failed = {}, []
    with torch.inference_mode():
        for arch, tp, m_prefill in GEMM_CASES:
            cfg = get_config(arch)
            g = torch.Generator(device=card).manual_seed(tp)
            w = _weights(cfg, card, g)
            shards = [{n: (t.chunk(tp, dim=1)[s].contiguous() if n not in ("q_norm", "k_norm")
                           else t) for n, t in w.items()} for s in range(tp)]
            for M, prefill in [(ROW_SLICE, False), (m_prefill, True)] + [
                    (m, True) for m in PREFILL_M]:
                h = torch.randn(M, cfg.d_model, generator=g, device=card).to(torch.bfloat16)
                pos = torch.randint(0, 4096, (M,), generator=g, device=card)
                # a decode slice through _shard_rows; a prefill's rows at
                # least PREFILL_MIN_ROWS, on both sides
                rows = (lambda fn, *t: fn(*t)) if prefill else \
                    (lambda fn, *t: _shard_rows(fn, tp, *t))
                mr = PREFILL_MIN_ROWS if prefill else 0
                tag = f"M{M}" + ("/prefill" if prefill else "")
                full = project_qkv(w, cfg, h[:, None, :], pos[:, None], mr)
                hid = swiglu_hidden(w, h, mr)
                got = [rows(lambda hh, pp, sp=sp: project_qkv(sp, cfg, hh[:, None, :],
                                                              pp[:, None], mr), h, pos)
                       for sp in shards]
                got_hid = [rows(lambda hh, sp=sp: swiglu_hidden(sp, hh, mr), h)
                           for sp in shards]
                for i, name in enumerate(("wq", "wk", "wv")):
                    key = f"{arch}/tp{tp}/{name}/{tag}"
                    record[key] = all(bool(torch.equal(got[s][i], part))
                                      for s, part in enumerate(full[i].chunk(tp, dim=2)))
                key = f"{arch}/tp{tp}/w_gate+w_up/{tag}"
                record[key] = all(bool(torch.equal(got_hid[s], part))
                                  for s, part in enumerate(hid.chunk(tp, dim=1)))
                failed += [k for k in record if k.startswith(f"{arch}/tp{tp}/") and
                           k.endswith(f"/{tag}") and not record[k]]
                if not prefill:  # the bare GEMMs unpadded, to name the one that moves
                    for name in ("wq", "wk", "wv", "w_gate", "w_up"):
                        wt = w[name].reshape(cfg.d_model, -1)
                        ref = h @ wt
                        record[f"{arch}/tp{tp}/{name}/M{M}/unpadded"] = all(
                            bool(torch.equal(h @ c.contiguous(), r))
                            for c, r in zip(wt.chunk(tp, dim=1), ref.chunk(tp, dim=1)))
    print(json.dumps({"tp_gemm_bitwise": record, "card": torch.cuda.get_device_name(0)}))
    assert not failed, f"a column-sharded bf16 GEMM moved a column's bits: {failed}"


@pytest.mark.cuda
def test_column_sharded_gemm_forms_record(card):
    """Which form of a shard's 64-row GEMM gives the unsharded GEMM's
    columns (recorded, not asserted; the executor's form is held above):
    unpadded, rows padded with zeros to tp x 64 (``_shard_rows``), to 128,
    256 and 4,096 rows, and ``F.linear``, for qwen3-14b's ``wk``/``wq``/
    ``w_gate`` (K = 5120) and qwen3-0.6b's ``wk`` (K = 1024) at tp 2, 4
    and 8.  Also whether the unsharded GEMM at 64 rows equals itself at
    4,096 rows (no split-K at 64).  Then the prefill GEMMs of short
    prompts (``PREFILL_M`` rows; ``PREFILL_GEMMS``), unpadded and with the
    rows padded to tp x M.  ``-s`` prints one ``tp_gemm_forms`` JSON line."""
    g = torch.Generator(device=card).manual_seed(0)
    bf16 = torch.bfloat16

    def pad(x, m):
        return torch.cat([x, x.new_zeros(m - x.shape[0], x.shape[1])])

    record = {}
    with torch.inference_mode():
        for name, K, N in (("qwen3-14b/wk", 5120, 1024), ("qwen3-14b/wq", 5120, 5120),
                           ("qwen3-14b/w_gate", 5120, 17408), ("qwen3-0.6b/wk", 1024, 1024)):
            w = (torch.randn(K, N, generator=g, device=card) / K ** 0.5).to(bf16)
            h = torch.randn(ROW_SLICE, K, generator=g, device=card).to(bf16)
            full = h @ w
            rec = {"unsharded_64_eq_4096": bool(torch.equal(full, (pad(h, 4096) @ w)[:64]))}
            for tp in (2, 4, 8):
                cols = [c.contiguous() for c in w.chunk(tp, dim=1)]
                want = full.chunk(tp, dim=1)
                forms = {"unpadded": lambda c: h @ c,
                         "rows_tp_x_64": lambda c: _shard_rows(lambda x: x @ c, tp, h),
                         "rows_128": lambda c: pad(h, 128) @ c,
                         "rows_256": lambda c: pad(h, 256) @ c,
                         "rows_4096": lambda c: pad(h, 4096) @ c,
                         "linear": lambda c: torch.nn.functional.linear(h, c.t())}
                rec[f"tp{tp}"] = {f: all(bool(torch.equal(fn(c)[:ROW_SLICE], ref))
                                         for c, ref in zip(cols, want))
                                  for f, fn in forms.items()}
            record[name] = rec
        # prefill GEMMs at small M (a short prompt prefilled alone: B x
        # _bucket(S, 16) rows), unpadded and with the rows padded to tp x M
        for name, K, N, tps in PREFILL_GEMMS:
            w = (torch.randn(K, N, generator=g, device=card) / K ** 0.5).to(bf16)
            rec = {}
            for M in PREFILL_M:
                h = torch.randn(M, K, generator=g, device=card).to(bf16)
                full = h @ w
                for tp in tps:
                    cols = [c.contiguous() for c in w.chunk(tp, dim=1)]
                    want = full.chunk(tp, dim=1)
                    rec[f"M{M}/tp{tp}"] = {
                        "unpadded": all(bool(torch.equal(h @ c, ref))
                                        for c, ref in zip(cols, want)),
                        "rows_tp_x_M": all(bool(torch.equal((pad(h, tp * M) @ c)[:M], ref))
                                           for c, ref in zip(cols, want))}
            record[f"prefill/{name}"] = rec
    print(json.dumps({"tp_gemm_forms": record, "card": torch.cuda.get_device_name(0)}))


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


SHARD_HEADS = [(8, 4), (4, 2), (20, 4)]  # qwen3-0.6b tp 2, tp 4; qwen3-14b tp 2


@pytest.mark.cuda
@pytest.mark.parametrize("dt_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,KV", SHARD_HEADS)
def test_paged_decode_at_shard_shapes(card, H, KV, dt_name):
    from repro_torch.kernels.paged_decode.ops import paged_decode_attention
    from repro_torch.kernels.paged_decode.ref import paged_decode_ref

    rng = random.Random(H)
    lens = [rng.randint(257, 800) for _ in range(8)]  # the serve cell's prompts + outputs
    q, kp, vp, bt, ln = _k1_case(card, 8, H, KV, 128, lens, getattr(torch, dt_name), seed=KV)
    got = paged_decode_attention(q, kp, vp, bt, ln)
    want = paged_decode_ref(q, kp, vp, bt, ln)
    tol = TOL[dt_name]
    err = (got.float() - want.float()).abs()
    assert bool((err <= tol + tol * want.float().abs()).all()), (H, KV, float(err.max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dt_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,KV", SHARD_HEADS)
def test_flash_prefill_at_shard_shapes(card, H, KV, dt_name):
    from repro_torch.kernels.flash_prefill.ops import flash_prefill
    from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref

    g = torch.Generator(device=card).manual_seed(H)
    dtype = getattr(torch, dt_name)
    q, k, v = (torch.randn(2, 512, n, 128, generator=g, device=card).to(dtype)
               for n in (H, KV, KV))
    got = flash_prefill(q, k, v, causal=True)
    want = flash_prefill_ref(q, k, v, causal=True)
    tol = TOL[dt_name]
    err = (got.float() - want.float()).abs()
    assert bool((err <= tol + tol * want.float().abs()).all()), (H, KV, float(err.max()))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen3-14b"])
def test_short_prompt_prefill_tp2_equals_tp1(card, arch):
    """Short prompts prefilled alone (one row of ``_bucket(S, 16)`` = 16 and
    48 tokens: the prefill GEMMs at M = 16 and 48, which the repair runs at
    ``PREFILL_MIN_ROWS``) give TP=2's first-token logits bitwise TP=1's, and
    the engine's greedy tokens of TP=2 (both shards on one card) equal
    TP=1's: full width, bf16, random weights from one seed, every row on
    the card.  ``-s`` prints one ``tp_short_prompt`` JSON line."""
    import gc

    import numpy as np

    from repro_torch.config import EngineConfig
    from repro_torch.core.engine import NeoEngine

    cfg = get_config(arch)
    prompts = [list(map(int, np.random.default_rng(s).integers(1, cfg.vocab_size, size=n)))
               for s, n in ((1, 9), (2, 16), (3, 40))]
    tokens, logits = {}, {}
    for tp in (1, 2):  # one engine at a time: qwen3-14b's two would not fit
        ecfg = EngineConfig(device_pool_pages=64, host_pool_pages=64, policy="neo",
                            hw_profile="h100_sxm", ewma_alpha=0.0, seed=0, tp=tp)
        eng = NeoEngine(cfg, ecfg, device=card,
                        shard_devices=[card] * tp if tp > 1 else None)
        tokens[tp] = []
        for p in prompts:  # one at a time: each prefilled alone
            rid = eng.submit(p, 8)
            tokens[tp].append(list(eng.run_until_done(500)[rid]))
        with torch.inference_mode():
            for p in prompts:
                S = 16 * -(-len(p) // 16)
                toks = torch.zeros(1, S, dtype=torch.int64)
                toks[0, :len(p)] = torch.tensor(p)
                lens = torch.tensor([len(p)], dtype=torch.int32)
                shards = eng.executor.tp_layers if tp > 1 else None
                logits[tp, S] = eng.model.prefill(toks, true_lens=lens, shards=shards)[0]
        eng.close()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    record = {"tokens_equal": tokens[2] == tokens[1]}
    for (tp, S), lg in logits.items():
        if tp == 2:
            record[f"logits_equal/S{S}"] = bool(torch.equal(lg, logits[1, S]))
    print(json.dumps({"tp_short_prompt": {arch: record},
                      "card": torch.cuda.get_device_name(0)}))
    assert all(record.values()), record
