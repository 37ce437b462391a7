"""Speculative decoding's verify pass on the card, bf16.

The verify pass (``NeoEngine._run_spec_chain``) feeds a row's drafts as
pseudo-rows at successive positions over the row's own pages, in one decode
call of K+1 pseudo-rows per drafting row.  Its tokens are serial decode's
only if pseudo-row j's logits are bitwise the ones serial decode computes at
that position, in a pass much larger than serial decode's: 16 rows at K = 4
pad to 128.  Two things carry that on the H100, and these tests measure
both:

* the decode step's row invariance across buckets: one row's four draft
  positions decoded serially, alone (bucket 8), against the same positions
  as pseudo-rows of verify passes padded to 8, 16, 32, 64, 128 and 256 rows
  (asserted bitwise, every bucket recorded; each GEMM of the step is also
  recorded across M = 8 to 256 with the cuBLAS kernel it ran, to name the
  GEMM if a bucket fails);
* K1 over pages the same decode call wrote a moment earlier: inside a
  verify pass, every launch of the paged decode kernel is held to its plain
  version on the very inputs it read (2e-2, the bf16 tolerance).

Full-width qwen3-0.6b (the widths decide the GEMM shapes and K1's grid),
depth cut to 4 layers, random weights and pool contents.  The tests carry
the ``cuda`` marker and skip without a card; ``-s`` shows the record (one
``spec_bucket_invariance`` and one ``spec_gemm_kernels`` JSON line).  No
JAX here: the card's machine has none.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import EngineConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.engine import NeoEngine, _SpecRow  # noqa: E402
from repro_torch.core.executor import _bucket  # noqa: E402
from repro_torch.core.request import Request, RequestState  # noqa: E402
from repro_torch.kernels.paged_decode import ops as paged_ops  # noqa: E402
from repro_torch.kernels.paged_decode.ref import paged_decode_ref  # noqa: E402

LAYERS = 4
K = 4  # drafts per row: pseudo-rows 0..K
BUCKETS = (8, 16, 32, 64, 128, 256)
BF16_TOL = 2e-2


@pytest.fixture(scope="module")
def engine():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the bf16 GEMMs and kernels of the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen3-0.6b").replace(num_layers=LAYERS)
    assert cfg.activation_dtype == "bfloat16"
    eng = NeoEngine(cfg, EngineConfig(device_pool_pages=16384, host_pool_pages=64,
                                      policy="neo", pipeline=False, hw_profile="h100_sxm",
                                      seed=0, spec_decode=True), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    for t in (eng.pool.device.k, eng.pool.device.v):
        t.copy_(torch.randn(t.shape, generator=g, device="cuda").to(t.dtype))
    yield eng
    eng.close()


def _tokens(eng, rng, n):
    return [int(t) for t in rng.integers(1, min(1000, eng.cfg.vocab_size), n)]


def _row(eng, rid, prompt_len, rng, extra=K):
    """A running device row with pages for ``extra`` positions past its
    next one (random pool contents stand for its prompt's K/V)."""
    vocab = min(1000, eng.cfg.vocab_size)
    r = Request(rid=rid, prompt=list(map(int, rng.integers(1, vocab, prompt_len))),
                max_new_tokens=64)
    r.state = RequestState.RUNNING
    r.out_tokens = [int(rng.integers(1, vocab))]
    page = eng.cfg.kv_block_size
    r.pages = eng.pool.device.alloc(-(-(r.kv_len + extra + 1) // page))
    return r


def _pseudo(r, tokens):
    """The verify pass's pseudo-rows of ``r`` feeding ``tokens`` at
    positions kv_len, kv_len + 1, ..."""
    return [_SpecRow(t, r.kv_len + j, r.pages) for j, t in enumerate(tokens)]


def _filler(eng, n, rng, rid0):
    """``n`` pseudo-rows of other rows (up to K + 1 each, as verify passes
    hold them), each row over its own pages."""
    rows = []
    while len(rows) < n:
        r = _row(eng, rid0 + len(rows), int(rng.integers(17, 900)), rng)
        m = min(K + 1, n - len(rows))
        rows += _pseudo(r, _tokens(eng, rng, m))
    return rows


def _record(ref, got):
    return {"bitwise_equal": bool(np.array_equal(ref, got)),
            "max_abs_diff": float(np.abs(ref - got).max()),
            "argmax_equal": bool(ref.argmax() == got.argmax())}


@pytest.mark.cuda
def test_card_verify_pseudo_rows_bitwise_across_buckets(engine):
    """One row fed its base token and K drafts serially, one decode pass per
    position alone (bucket 8): those logits are the serial path's.  Then the
    same K + 1 positions as pseudo-rows of one verify pass, among other rows'
    pseudo-rows, with the pass padded to each of 8 ... 256 rows: every
    pseudo-row's logits must equal the serial ones bitwise (the verify
    pass rewrites the row's K/V at those positions before reading them, so
    each pass stands alone)."""
    eng = engine
    rng = np.random.default_rng(0)
    target = _row(eng, 0, 300, rng)
    feeds = [target.all_tokens[-1]] + _tokens(eng, rng, K)
    serial = [eng.executor.decode(_pseudo(target, feeds)[j:j + 1], [False])[0]
              for j in range(K + 1)]
    record, failed = {}, []
    for B in BUCKETS:
        n = max(K + 1, B - 3)  # B - 3 rows pad to bucket B (5 rows to 8)
        fill = _filler(eng, n - (K + 1), rng, 1000 * B)
        half = len(fill) // 2
        rows = fill[:half] + _pseudo(target, feeds) + fill[half:]
        assert _bucket(len(rows)) == B
        logits = eng.executor.decode(rows, [False] * len(rows))
        got = [_record(serial[j], logits[half + j]) for j in range(K + 1)]
        record[f"bucket {B}"] = {
            "rows": len(rows),
            "bitwise_equal_by_pseudo_row": [g["bitwise_equal"] for g in got],
            "argmax_equal_by_pseudo_row": [g["argmax_equal"] for g in got],
            "max_abs_diff": max(g["max_abs_diff"] for g in got)}
        if not all(g["bitwise_equal"] for g in got):
            failed.append(B)
    print(json.dumps({"spec_bucket_invariance": record}))
    assert not failed, f"pseudo-row logits differ from serial decode in buckets {failed}"


@pytest.mark.cuda
def test_card_gemm_kernels_across_buckets_record(engine):
    """Recorded, not asserted: each GEMM of the decode step at the full
    widths, one fixed input row among random ones, at M = 16 ... 256 against
    M = 8, with the names of the CUDA kernels each M ran (torch.profiler):
    the GEMM whose cuBLAS algorithm changes with M, should a bucket fail."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eng = engine
    model = eng.model
    blk = model.layers[0]
    d, H, hd = eng.cfg.d_model, eng.cfg.num_heads, eng.cfg.head_dim
    gemms = {
        "wq": (d, lambda x: x @ blk.attn["wq"].reshape(d, -1)),
        "wk": (d, lambda x: x @ blk.attn["wk"].reshape(d, -1)),
        "wv": (d, lambda x: x @ blk.attn["wv"].reshape(d, -1)),
        "wo": (H * hd, lambda x: x @ blk.attn["wo"].reshape(H * hd, d)),
        "w_gate": (d, lambda x: x @ blk.mlp["w_gate"]),
        "w_up": (d, lambda x: x @ blk.mlp["w_up"]),
        "w_down": (eng.cfg.d_ff, lambda x: x @ blk.mlp["w_down"]),
        "final_logits": (d, model.final_logits),
    }
    g = torch.Generator(device="cuda").manual_seed(5)
    record = {}
    with torch.inference_mode():
        for name, (width, fn) in gemms.items():
            row = torch.randn(width, generator=g, device="cuda").to(model.act_dtype)
            outs, kernels = {}, {}
            for M in BUCKETS:
                x = torch.randn(M, width, generator=g, device="cuda").to(model.act_dtype)
                x[3] = row
                fn(x)  # warm
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    y = fn(x)
                    torch.cuda.synchronize()
                outs[M] = y[3].float().cpu().numpy()
                kernels[M] = sorted({e.name[:80] for e in prof.events()
                                     if e.device_type == DeviceType.CUDA})
            record[name] = {f"M={M}": {**_record(outs[8], outs[M]), "kernels": kernels[M]}
                            for M in BUCKETS[1:]}
            record[name]["M=8"] = {"kernels": kernels[8]}
    print(json.dumps({"spec_gemm_kernels": record}))


@pytest.mark.cuda
def test_card_k1_over_pages_written_in_the_same_call(engine, monkeypatch):
    """Inside verify passes (bucket 16 and 128), every launch of the paged
    decode kernel reads pages the same decode call scattered a moment
    earlier (pseudo-row j over the K/V of pseudo-rows < j): each launch is
    held to its plain version on the inputs it read."""
    eng = engine
    rng = np.random.default_rng(7)
    kernel = paged_ops.paged_decode_attention
    worst, calls = [0.0], [0]

    def checked(q, k_pages, v_pages, tables, lens):
        out = kernel(q, k_pages, v_pages, tables, lens)
        torch.cuda.synchronize()
        want = paged_decode_ref(q, k_pages, v_pages, tables, lens).float()
        err = (out.float() - want).abs()
        assert bool((err <= BF16_TOL + BF16_TOL * want.abs()).all()), float(err.max())
        worst[0] = max(worst[0], float(err.max()))
        calls[0] += 1
        return out

    # the wrapper's launch counters are the ones the kernel's launch bumps
    checked.launches = checked.merge_launches = 0
    monkeypatch.setattr(paged_ops, "paged_decode_attention", checked)
    page = eng.cfg.kv_block_size
    for B in (16, 128):
        target = _row(eng, 50_000 + B, 600, rng)
        feeds = [target.all_tokens[-1]] + _tokens(eng, rng, K)
        rows = _pseudo(target, feeds) + _filler(eng, B - 3 - (K + 1), rng, 60_000 + 1000 * B)
        # the K/V slots of the target's K + 1 positions start empty, so the
        # kernel can only read what this call writes there
        pos = np.arange(target.kv_len, target.kv_len + K + 1)
        pids = torch.tensor([target.pages[p // page] for p in pos], device="cuda")
        offs = torch.tensor(pos % page, device="cuda")
        for t in (eng.pool.device.k, eng.pool.device.v):
            t[:, pids, offs] = 0
        logits = eng.executor.decode(rows, [False] * len(rows))
        assert np.isfinite(logits).all()
        for t in (eng.pool.device.k, eng.pool.device.v):
            assert bool((t[:, pids, offs].float().abs().amax(dim=(-2, -1)) > 0).all())
    assert calls[0] == 2 * LAYERS
    print(json.dumps({"spec_k1_same_call_pages": {"launches_checked": calls[0],
                                                  "max_abs_err": worst[0]}}))
