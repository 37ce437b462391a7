"""Kernel table of the port (the counterpart of the JAX package's
``benchmarks/kernels.py``): the four hand-written kernels at the
reference benchmark's shapes (fp32) and at the main path's shapes (bf16).

On the card, per kernel and shape: the kernel's largest absolute error
against its plain version, the kernel's and the plain version's median
device time (CUDA events, L2 flushed before each launch), the time of the
one PyTorch call that computes the same function where there is one
(``scaled_dot_product_attention``; none computes either scan), and the
bound: the larger of the bytes the function must move over the card's
memory rate and its operations over the peak rate of their unit.  On the
CPU (``--device cpu``), where the wrappers run their plain versions: the
plain version against the other plain form ``ref.py`` keeps (the scans'
staged kernel mirrors; the attention kernels' ``ref.py`` is the plain
version itself), with its wall time.  The JSON lands in
``build/figures/kernels.json``.

The helpers (``time_ms``, the bounds, the rates) are the ones
``chip_smoke.py`` times its kernels with.

  PYTHONPATH=src python -m repro_torch.benchmarks.kernels
  PYTHONPATH=src python -m repro_torch.benchmarks.kernels --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.benchmarks.common import print_table, save_json
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_prefill import ops as flash_ops
from repro_torch.kernels.flash_prefill.ops import prefill_pairs  # noqa: F401  (re-exported)
from repro_torch.kernels.mamba2_ssd import ops as mamba2_ops
from repro_torch.kernels.paged_decode import ops as paged_ops
from repro_torch.kernels.rwkv6_scan import ops as rwkv6_ops

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores
TOL = {"float32": 2e-3, "bfloat16": 2e-2}  # tests/test_kernels.py tolerances


def time_ms(fn, flush, iters=30, warmup=3):
    """Median device time of ``fn`` with L2 flushed before each launch (the
    main path finds each layer's pages cold)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(iters):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    ts = sorted(s.elapsed_time(e) for s, e in evs)
    return ts[len(ts) // 2]


def wall_ms(fn, iters=5):
    """Median wall time of ``fn`` on the host (the CPU's table)."""
    fn()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return sorted(ts)[len(ts) // 2]


def _bounded(nbytes, flops, flops_per_s):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def bound(q, lens, page, KV, hd):
    """Least time for the work this input needs (``paged_decode.ops.work``:
    each needed K/V token, q, the output, lens and the needed block-table
    entries once; 4*H*hd FLOPs per token), the FLOPs at the f32 rate
    (outside the tensor cores)."""
    return _bounded(*paged_ops.work(q, lens, page, KV, hd), F32_FLOPS)


def flash_bound(q, k, causal, window, flops_per_s=BF16_FLOPS):
    """Least time for ``flash_prefill.ops.work`` (q, k, v and the output
    once; 4 hd FLOPs per (query, key) pair a head sees) at 3.35 TB/s and
    ``flops_per_s`` (the bf16 tensor-core rate by default)."""
    return _bounded(*flash_ops.work(q, k, k, causal, window), flops_per_s)


def scan_bound(nbytes, flops, dtype):
    """Least time for the work: bytes at 3.35 TB/s, or the recurrence's
    operations at the peak of the unit that runs the kernel's products (the
    bf16 tensor cores, or f32 FFMA)."""
    return _bounded(nbytes, flops, BF16_FLOPS if dtype == "bfloat16" else F32_FLOPS)


def rwkv6_bound(args):
    """Least time for ``rwkv6_scan.ops.work`` (each input and output byte
    once; 4 N^2 operations per token per head)."""
    return scan_bound(*rwkv6_ops.work(*args), str(args[0].dtype).split(".")[-1])


def mamba2_bound(args):
    """Least time for ``mamba2_ssd.ops.work`` (each input and output byte
    once; 5 N P operations per token per head)."""
    return scan_bound(*mamba2_ops.work(*args), str(args[0].dtype).split(".")[-1])


def paged_library_call(q, kp, vp, bt, ln, page):
    """scaled_dot_product_attention over K/V gathered ahead of time into a
    contiguous [B, KV, S, hd] tensor, with a length mask (yardstick only)."""
    import torch.nn.functional as F

    B, H, hd = q.shape
    KV = kp.shape[2]
    S = bt.shape[1] * page
    k = kp[bt.long()].reshape(B, S, KV, hd).transpose(1, 2).contiguous()
    v = vp[bt.long()].reshape(B, S, KV, hd).transpose(1, 2).contiguous()
    mask = (torch.arange(S, device=q.device)[None, :] < ln[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    return lambda: F.scaled_dot_product_attention(q4, k, v, attn_mask=mask, enable_gqa=True)


# ---------------------------------------------------------------------------
# inputs, one function per kernel: (label, shape) -> (args, bound, library)
# ---------------------------------------------------------------------------


def _randn(g, shape, device, dtype=torch.float32):
    return torch.randn(*shape, generator=g, device=device).to(dtype)


def paged_case(device, dtype, *, B, H, KV, hd, page, P, maxp, lens, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    q = _randn(g, (B, H, hd), device, dtype)
    kp = _randn(g, (P, page, KV, hd), device, dtype)
    vp = _randn(g, (P, page, KV, hd), device, dtype)
    bt = torch.randint(0, P, (B, maxp), generator=g, device=device, dtype=torch.int32)
    ln = torch.tensor(lens, dtype=torch.int32, device=device)
    args = (q, kp, vp, bt, ln)
    return args, bound(q, lens, page, KV, hd), (lambda: paged_library_call(q, kp, vp, bt, ln,
                                                                           page))


def flash_case(device, dtype, *, B, S, H, KV, hd, causal=True, window=0, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (_randn(g, (B, S, n, hd), device, dtype) for n in (H, KV, KV))
    peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS

    def library():
        import torch.nn.functional as F

        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                      enable_gqa=True)
    return (q, k, v), flash_bound(q, k, causal, window, peak), library


def rwkv6_case(device, dtype, *, B, T, H, N, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    r, k, v = (_randn(g, (B, T, H, N), device, dtype) for _ in range(3))
    w = torch.exp(-torch.exp(_randn(g, (B, T, H, N), device)))  # decay in (0, 1)
    u = _randn(g, (H, N), device)
    s0 = torch.zeros(B, H, N, N, device=device)
    args = (r, k, v, w, u, s0)
    return args, rwkv6_bound(args), None


def mamba2_case(device, dtype, *, B, T, H, P, N, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = _randn(g, (B, T, H, P), device, dtype)
    dt = 0.001 + 0.099 * torch.rand(B, T, H, generator=g, device=device)
    A = -(0.5 + 1.5 * torch.rand(H, generator=g, device=device))
    Bm = _randn(g, (B, T, N), device, dtype)
    Cm = _randn(g, (B, T, N), device, dtype)
    D = _randn(g, (H,), device)
    s0 = torch.zeros(B, H, N, P, device=device)  # [B, H, N, P], the port's layout
    args = (x, dt, A, Bm, Cm, D, s0)
    return args, mamba2_bound(args), None


def _lens(n, lo, hi, seed):
    return [int(x) for x in np.random.default_rng(seed).integers(lo, hi, size=n)]


# (kernel, label, dtype, case function, shape): the reference benchmark's
# shapes (benchmarks/kernels.py, fp32) and the main path's (PERF.md §6, bf16)
CASES = [
    ("paged_decode", "reference", "float32", paged_case,
     dict(B=4, H=8, KV=4, hd=64, page=16, P=256, maxp=16, lens=_lens(4, 32, 256, 0))),
    ("paged_decode", "main", "bfloat16", paged_case,
     dict(B=8, H=16, KV=8, hd=128, page=16, P=512, maxp=50, lens=_lens(8, 257, 801, 1))),
    ("flash_prefill", "reference", "float32", flash_case,
     dict(B=1, S=256, H=4, KV=2, hd=64)),
    ("flash_prefill", "main", "bfloat16", flash_case,
     dict(B=1, S=512, H=16, KV=8, hd=128)),
    ("rwkv6_scan", "reference", "float32", rwkv6_case, dict(B=1, T=64, H=4, N=32)),
    ("rwkv6_scan", "main", "bfloat16", rwkv6_case, dict(B=1, T=512, H=64, N=64)),
    ("mamba2_ssd", "reference", "float32", mamba2_case, dict(B=1, T=64, H=2, P=32, N=32)),
    ("mamba2_ssd", "main", "bfloat16", mamba2_case, dict(B=1, T=512, H=112, P=64, N=64)),
]


def kernel_fns(name):
    """(wrapper, plain version, the other plain form in ref.py) of a kernel;
    every output is a tensor or a tuple whose first entry is the output."""
    if name == "paged_decode":
        from repro_torch.kernels.paged_decode.ops import paged_decode_attention as kern
        from repro_torch.kernels.paged_decode.ref import paged_decode_ref as plain
        return kern, plain, plain
    if name == "flash_prefill":
        from repro_torch.kernels.flash_prefill.ops import flash_prefill as kern
        from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref as plain
        return kern, plain, plain
    if name == "rwkv6_scan":
        from repro_torch.kernels.rwkv6_scan.ops import CHUNK, rwkv6_scan as kern
        from repro_torch.kernels.rwkv6_scan.ref import rwkv6_chunked, rwkv6_staged
        return kern, (lambda *a: rwkv6_chunked(*a, chunk=CHUNK)), rwkv6_staged
    from repro_torch.kernels.mamba2_ssd.ops import CHUNK, mamba2_ssd as kern
    from repro_torch.kernels.mamba2_ssd.ref import mamba2_ssd_chunked, mamba2_ssd_staged
    return kern, (lambda *a: mamba2_ssd_chunked(*a, chunk=CHUNK)), mamba2_ssd_staged


def _max_err(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))


def _check(name, label, dt_name, got, want, *, of_largest=False):
    """The largest absolute error; raises past TOL: abs + rel per element
    (the tests'), or with ``of_largest`` TOL of the output's largest
    magnitude (the rule for two chunked scans that sum in other orders:
    their sums of N terms cancel to small entries)."""
    tol = TOL[dt_name]
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        a, b = a.float(), b.float()
        lim = tol * float(b.abs().max()) if of_largest else tol + tol * b.abs()
        if not (bool(torch.isfinite(a).all()) and bool(((a - b).abs() <= lim).all())):
            raise AssertionError(f"{name} ({label}, {dt_name}) disagrees with its plain "
                                 f"version: max_abs_err {_max_err(got, want):.3e}")
    return _max_err(got, want)


def run_table(device=None, *, labels=("reference", "main")):
    """One row per kernel and shape (see the module docstring); raises when
    a kernel (on the card) or a plain version (on the CPU) is past TOL."""
    dev = resolve_device(device)
    rows = []
    flush = (torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=dev)
             if dev.type == "cuda" else None)
    for name, label, dt_name, case, shape in CASES:
        if label not in labels:
            continue
        kern, plain, other = kernel_fns(name)
        args, (b_ms, b_by), library = case(dev, getattr(torch, dt_name), **shape)
        shape_s = " ".join(f"{k}={v}" for k, v in shape.items()
                           if k not in ("lens", "P", "maxp"))
        if name == "paged_decode":
            shape_s += f" sum(lens)={sum(shape['lens'])}"
        row = dict(kernel=name, shape_of=label, dtype=dt_name, shape=shape_s,
                   device=str(dev), bound_ms=b_ms, bound_by=b_by)
        if dev.type == "cuda":
            got = kern(*args)
            torch.cuda.synchronize()
            row["max_abs_err"] = _check(name, label, dt_name, got, plain(*args))
            row["ms"] = time_ms(lambda: kern(*args), flush)
            row["plain_ms"] = time_ms(lambda: plain(*args), flush)
            row["library_ms"] = time_ms(library(), flush) if library else None
        else:
            # the wrapper runs the plain version here; hold it to ref.py's
            # other form and time it on the host
            row["max_abs_err"] = _check(name, label, dt_name, kern(*args), other(*args),
                                        of_largest=name in ("rwkv6_scan", "mamba2_ssd"))
            row["plain_ms"] = wall_ms(lambda: kern(*args))
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default: the card) or cpu")
    ap.add_argument("--shapes", default="reference,main",
                    help="comma-separated: reference (the JAX benchmark's), main")
    args = ap.parse_args(argv)
    rows = run_table(args.device, labels=tuple(args.shapes.split(",")))
    print("=== Kernels: max |kernel - plain| (CPU: plain vs ref.py), ms, bound ===")

    def fmt(x):
        return "-" if x is None else (f"{x:.4f}" if isinstance(x, float) else x)
    print_table(["kernel", "shape", "dtype", "max err", "kernel ms", "plain ms", "library ms",
                 "bound ms", "by"],
                [[r["kernel"], r["shape_of"], r["dtype"], f"{r['max_abs_err']:.1e}",
                  fmt(r.get("ms")), fmt(r["plain_ms"]), fmt(r.get("library_ms")),
                  fmt(r["bound_ms"]), r["bound_by"]] for r in rows])
    save_json("kernels.json", rows)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
