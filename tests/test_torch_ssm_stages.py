"""The three-stage decomposition the scan kernels run (chunk states, state
passing, chunk outputs), in its plain PyTorch form: ``mamba2_ssd_staged``
and ``rwkv6_staged`` against the plain chunked scans and the JAX package's
oracles in f32, and with the kernels' bf16 operand rounding against the
plain scans at the card's bf16 tolerance.  Every test draws its inputs from
its own seeded numpy generator."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels.mamba2_ssd import ref as ref_ssd  # noqa: E402
from repro.kernels.rwkv6_scan import ref as ref_rwkv  # noqa: E402

from repro_torch.testing import one_thread  # noqa: E402,F401
from repro_torch.kernels.mamba2_ssd.ref import mamba2_ssd_chunked, mamba2_ssd_staged  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ref as rwkv_ref  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_chunked, rwkv6_staged  # noqa: E402

CARD_TOL = 2e-2  # the bf16 tolerance the card holds the kernels to (abs + rel)


def _rwkv6_inputs(seed, B, T, H, N, strong=False, tiny_every=0):
    """The reference sweep's inputs (tests/test_kernels.py:100); ``strong``
    puts log w near -5 per step, ``tiny_every`` sets w = 1e-40 on every
    such token (log w at its 1e-38 floor)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, T, H, N)).astype(np.float32) for _ in range(3))
    z = rng.normal(size=(B, T, H, N))
    if strong:
        z = np.log(5.0) + 0.1 * z
    w = np.exp(-np.exp(z)).astype(np.float32)
    if tiny_every:
        w[:, ::tiny_every] = 1e-40
    u = rng.normal(size=(H, N)).astype(np.float32)
    s0 = (rng.normal(size=(B, H, N, N)) * 0.1).astype(np.float32)
    return r, k, v, w, u, s0


def _mamba2_inputs(seed, B, T, H, P, N, strong=False):
    """The reference sweep's inputs (tests/test_kernels.py:137, state as
    [B, H, N, P]); ``strong`` puts the log decay near -4 per step."""
    rng = np.random.default_rng(seed)
    lo, hi, alo, ahi = (1.0, 3.0, 1.0, 3.0) if strong else (0.001, 0.1, 0.5, 2.0)
    x = rng.normal(size=(B, T, H, P)).astype(np.float32)
    dt = rng.uniform(lo, hi, size=(B, T, H)).astype(np.float32)
    A = -rng.uniform(alo, ahi, size=(H,)).astype(np.float32)
    Bm, C = (rng.normal(size=(B, T, N)).astype(np.float32) for _ in range(2))
    D = rng.normal(size=(H,)).astype(np.float32)
    s0 = (rng.normal(size=(B, H, N, P)) * 0.1).astype(np.float32)
    return x, dt, A, Bm, C, D, s0


def _pad(a, pad, value=0.0):
    return np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2), constant_values=value)


def _close_to_scale(got, want, rel=1e-5):
    """Same algorithm, other summation order: bound by ``rel`` of the
    output's largest magnitude (as the slices' oracle tests do)."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * float(np.abs(want).max()))


def _outside(got, want, tol=CARD_TOL):
    """Entries outside the card's abs + rel tolerance."""
    err = (got.float() - want.float()).abs()
    return int((err > tol + tol * want.float().abs()).sum())


def _bf16(arrs, n_exact):
    """The first ``n_exact`` inputs in bfloat16 (the kernels' bf16 operands),
    the rest f32."""
    ts = [torch.from_numpy(a) for a in arrs]
    return [t.bfloat16() if i < n_exact else t for i, t in enumerate(ts)]


# tests/test_torch_rwkv6.py:76 and tests/test_torch_mamba2_zamba2.py:79, then
# T = 1 and T = 15 (a lone partial chunk)
RWKV6_SHAPES = [(1, 32, 2, 16, False), (2, 64, 4, 32, False), (1, 100, 2, 16, False),
                (2, 40, 3, 32, True), (1, 1, 2, 16, False), (1, 15, 3, 16, False)]
MAMBA2_SHAPES = [(1, 32, 2, 16, 16, False), (2, 64, 2, 32, 32, False),
                 (1, 100, 3, 32, 16, False), (2, 130, 4, 24, 40, True),
                 (1, 1, 2, 16, 16, False), (1, 15, 3, 32, 16, False)]


@pytest.mark.parametrize("B,T,H,N,strong", RWKV6_SHAPES)
@pytest.mark.parametrize("tiny_every", [0, 7])
def test_rwkv6_staged_matches_plain_and_oracle(B, T, H, N, strong, tiny_every):
    arrs = _rwkv6_inputs(41, B, T, H, N, strong, tiny_every)
    ts = [torch.from_numpy(a) for a in arrs]
    y, sT = rwkv6_staged(*ts)
    y_p, s_p = rwkv6_chunked(*ts)
    _close_to_scale(y.numpy(), y_p.numpy())
    _close_to_scale(sT.numpy(), s_p.numpy())
    if tiny_every:
        # the JAX oracle floors w at 1e-38, a subnormal that XLA on the CPU
        # flushes to zero: its log is -inf and the oracle returns NaN
        return
    pad = (-T) % 16
    r, k, v, w, u, s0 = arrs
    padded = (_pad(r, pad), _pad(k, pad), _pad(v, pad), _pad(w, pad, 1.0), u, s0)
    y_ref, s_ref = ref_rwkv.rwkv6_chunked_ref(*map(jnp.asarray, padded))
    _close_to_scale(y.numpy(), np.asarray(y_ref)[:, :T])
    _close_to_scale(sT.numpy(), s_ref)


@pytest.mark.parametrize("B,T,H,P,N,strong", MAMBA2_SHAPES)
def test_mamba2_staged_matches_plain_and_oracle(B, T, H, P, N, strong):
    arrs = _mamba2_inputs(42, B, T, H, P, N, strong)
    ts = [torch.from_numpy(a) for a in arrs]
    y, sT = mamba2_ssd_staged(*ts)
    y_p, s_p = mamba2_ssd_chunked(*ts)
    _close_to_scale(y.numpy(), y_p.numpy())
    _close_to_scale(sT.numpy(), s_p.numpy())
    pad = (-T) % 64
    x, dt, A, Bm, C, D, s0 = arrs
    padded = (_pad(x, pad), _pad(dt, pad), A, _pad(Bm, pad), _pad(C, pad), D, s0)
    y_ref, s_ref = ref_ssd.mamba2_ssd_chunked_ref(*map(jnp.asarray, padded))
    _close_to_scale(y.numpy(), np.asarray(y_ref)[:, :T])
    _close_to_scale(sT.numpy(), s_ref)


# chip_smoke.py's sweep (the full-width shapes included) and the card tests'
# largest head
@pytest.mark.parametrize("B,T,H,N,strong", [
    (1, 32, 2, 16, False), (2, 64, 4, 32, False), (1, 100, 2, 16, False),
    (2, 40, 3, 64, True), (1, 300, 8, 128, False), (1, 512, 64, 64, False),
    (1, 768, 64, 64, False)])
def test_rwkv6_split_bf16_within_card_tolerance(B, T, H, N, strong):
    args = _bf16(_rwkv6_inputs(43, B, T, H, N, strong), 3)
    y, sT = rwkv6_staged(*args, split_bf16=True)
    y_p, s_p = rwkv6_chunked(*args)
    assert _outside(y, y_p) == 0 and _outside(sT, s_p) == 0


# the below-FLT_MIN cases of the card tests and chip_smoke.py (w = 1e-40 on
# every 7th token)
@pytest.mark.parametrize("B,T,H,N", [(2, 70, 3, 32), (1, 512, 64, 64)])
def test_rwkv6_split_bf16_below_flt_min_within_card_tolerance(B, T, H, N):
    args = _bf16(_rwkv6_inputs(47, B, T, H, N, tiny_every=7), 3)
    y, sT = rwkv6_staged(*args, split_bf16=True)
    y_p, s_p = rwkv6_chunked(*args)
    assert _outside(y, y_p) == 0 and _outside(sT, s_p) == 0


@pytest.mark.parametrize("B,T,H,P,N,strong", [
    (1, 32, 2, 16, 16, False), (2, 64, 2, 32, 32, False), (1, 100, 3, 32, 16, False),
    (2, 130, 4, 24, 40, True), (1, 200, 4, 64, 128, False), (1, 512, 112, 64, 64, False),
    (1, 768, 112, 64, 64, False)])
def test_mamba2_split_bf16_within_card_tolerance(B, T, H, P, N, strong):
    args = _bf16(_mamba2_inputs(44, B, T, H, P, N, strong), 1)
    for i in (3, 4):  # B and C in bf16 too
        args[i] = args[i].bfloat16()
    y, sT = mamba2_ssd_staged(*args, split_bf16=True)
    y_p, s_p = mamba2_ssd_chunked(*args)
    assert _outside(y, y_p) == 0 and _outside(sT, s_p) == 0


def test_rwkv6_single_bf16_rounding_fails_card_tolerance(monkeypatch):
    """Why the kernel splits every f32 operand: rounding each to one bf16
    leaves entries outside the card's tolerance at (1, 300, 8, 128)."""
    args = _bf16(_rwkv6_inputs(45, 1, 300, 8, 128), 3)
    y_p, _ = rwkv6_chunked(*args)
    y, _ = rwkv6_staged(*args, split_bf16=True)
    assert _outside(y, y_p) == 0

    def single(a, split_bf16):
        if not split_bf16:
            return [a]
        hi = a.to(torch.bfloat16).float()
        return [hi, torch.zeros_like(hi)]

    monkeypatch.setattr(rwkv_ref, "_split", single)
    y1, _ = rwkv6_staged(*args, split_bf16=True)
    assert _outside(y1, y_p) > 100


@pytest.mark.parametrize("staged,plain,make", [
    (rwkv6_staged, rwkv6_chunked, lambda: _rwkv6_inputs(46, 2, 0, 3, 16)),
    (mamba2_ssd_staged, mamba2_ssd_chunked, lambda: _mamba2_inputs(46, 2, 0, 3, 16, 8))])
def test_staged_forms_take_an_empty_sequence(staged, plain, make):
    ts = [torch.from_numpy(a) for a in make()]
    y, sT = staged(*ts)
    y_p, s_p = plain(*ts)
    assert y.shape == y_p.shape and y.numel() == 0
    assert torch.equal(sT, s_p)
