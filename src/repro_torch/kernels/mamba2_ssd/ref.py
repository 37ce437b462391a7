"""Plain PyTorch version of the chunked Mamba2 SSD recurrence: the same
function as the CUDA kernel in ``csrc/mamba2_ssd.cu`` and the JAX package's
``mamba2_ssd_chunked_ref``.  The wrapper uses it for CPU tensors; the tests
and ``chip_smoke.py`` hold the kernel to it on the card.

Per head h (state N, head channels P), scalar decay a_t = exp(dt_t * A_h),
one B/C group shared by all heads:

    S_t[n, p] = a_t * S_{t-1}[n, p] + dt_t * B_t[n] * x_t[p]
    y_t[p]    = sum_n C_t[n] * S_t[n, p] + D_h * x_t[p]

computed a chunk of tokens at a time with a [C, C] pair-decay matrix clipped
at ±60; y is rounded to x's dtype once, after the D·x skip is added in f32.
Unlike the reference, any T is taken: the tail is padded with dt = 0 and
x = B = C = 0, which adds nothing to y or S and decays nothing.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

CLIP = 60.0


def mamba2_ssd_chunked(
    x: torch.Tensor,  # [B, T, H, P]
    dt: torch.Tensor,  # [B, T, H] (post-softplus, > 0)
    A: torch.Tensor,  # [H] (negative)
    Bm: torch.Tensor,  # [B, T, N]
    Cm: torch.Tensor,  # [B, T, N]
    D: torch.Tensor,  # [H]
    state0: torch.Tensor,  # [B, H, N, P]
    chunk: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y [B, T, H, P] in x's dtype, final state [B, H, N, P] f32)."""
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    C = chunk
    pad = (-T) % C
    x32, dt32, B32, C32 = (a.float() for a in (x, dt, Bm, Cm))
    if pad:
        x32 = F.pad(x32, (0, 0, 0, 0, 0, pad))
        dt32 = F.pad(dt32, (0, 0, 0, pad))
        B32 = F.pad(B32, (0, 0, 0, pad))
        C32 = F.pad(C32, (0, 0, 0, pad))
    n = (T + pad) // C
    x32 = x32.reshape(Bsz, n, C, H, P)
    dt32 = dt32.reshape(Bsz, n, C, H)
    B32 = B32.reshape(Bsz, n, C, N)
    C32 = C32.reshape(Bsz, n, C, N)
    A32, D32 = A.float(), D.float()
    causal = torch.tril(torch.ones(C, C, dtype=torch.bool, device=x.device))
    S = state0.float()
    ys = []
    for c in range(n):
        xt, dtt, bt, ct = x32[:, c], dt32[:, c], B32[:, c], C32[:, c]
        cum = torch.cumsum(dtt * A32, dim=1)  # [B, C, H] inclusive log decay
        y_state = torch.einsum("bcn,bch,bhnp->bchp", ct, torch.exp(cum), S)
        pair = torch.exp(torch.clamp(cum[:, :, None] - cum[:, None, :], -CLIP, CLIP))
        scores = torch.einsum("btn,bsn->bts", ct, bt)[..., None] * pair
        scores = scores * causal[None, :, :, None]
        xdt = xt * dtt[..., None]  # [B, C, H, P]
        y_intra = torch.einsum("btsh,bshp->bthp", scores, xdt)
        ys.append(y_state + y_intra + D32[None, None, :, None] * xt)
        total = cum[:, -1]  # [B, H]
        k_dec = torch.exp(torch.clamp(total[:, None] - cum, -CLIP, CLIP))  # [B, C, H]
        S = torch.exp(total)[..., None, None] * S + torch.einsum(
            "bsn,bsh,bshp->bhnp", bt, k_dec, xdt)
    y = torch.cat(ys, dim=1)[:, :T] if ys else x32.new_zeros(Bsz, 0, H, P)
    return y.to(x.dtype), S


def _split(a: torch.Tensor, split_bf16: bool, pair: bool):
    """The operand(s) a product of the kernel's bf16 path takes for the f32
    ``a``: itself (f32 path), one bf16 rounding, or a bf16 hi + lo pair whose
    sum carries ~16 bits of a's mantissa.  Returned in f32 so that the
    products accumulate in f32, as the tensor cores do."""
    if not split_bf16:
        return [a]
    hi = a.to(torch.bfloat16).float()
    return [hi, (a - hi).to(torch.bfloat16).float()] if pair else [hi]


def mamba2_ssd_staged(
    x: torch.Tensor,  # [B, T, H, P]
    dt: torch.Tensor,  # [B, T, H]
    A: torch.Tensor,  # [H]
    Bm: torch.Tensor,  # [B, T, N]
    Cm: torch.Tensor,  # [B, T, N]
    D: torch.Tensor,  # [H]
    state0: torch.Tensor,  # [B, H, N, P]
    chunk: int = 64,
    split_bf16: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's three stages in plain PyTorch (tests only):

    1. chunk states, every chunk at once: ``cum`` (inclusive log decay),
       ``total`` and ``L_c = (B * exp(clip(total - cum)) * dt)^T x``;
    2. state passing, the only walk over chunks: ``S_in[c+1] =
       exp(total_c) S_in[c] + L_c`` from ``S_in[0] = state0``;
    3. chunk outputs, every chunk at once: ``y = (CB^T * exp(clip(cum_t -
       cum_s)) * dt_s)_{s<=t} x + exp(cum_t) (C S_in) + D x``.

    ``split_bf16`` rounds every product operand as the kernel's bf16 path
    does: x, B and C (bf16 inputs) exactly; the stage-1 weight ``B * decay *
    dt`` once; the stage-3 scores and ``S_in`` as hi + lo pairs.  Every
    exponent is <= 0 for dt >= 0 and A <= 0.  Same result as
    :func:`mamba2_ssd_chunked` up to f32 summation order."""
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    C = chunk
    pad = (-T) % C
    x32, dt32, B32, C32 = (a.float() for a in (x, dt, Bm, Cm))
    if pad:
        x32 = F.pad(x32, (0, 0, 0, 0, 0, pad))
        dt32 = F.pad(dt32, (0, 0, 0, pad))
        B32 = F.pad(B32, (0, 0, 0, pad))
        C32 = F.pad(C32, (0, 0, 0, pad))
    n = (T + pad) // C
    if split_bf16:  # the kernel's operands x, B, C are bf16
        x32, B32, C32 = (a.to(torch.bfloat16).float() for a in (x32, B32, C32))
    xc = x32.reshape(Bsz, n, C, H, P)
    dtc = dt32.reshape(Bsz, n, C, H)
    Bc = B32.reshape(Bsz, n, C, N)
    Cc = C32.reshape(Bsz, n, C, N)
    # -- stage 1: chunk states -----------------------------------------------------
    cum = torch.cumsum(dtc * A.float(), dim=2)  # [B, n, C, H]
    total = cum[:, :, -1]  # [B, n, H]
    wgt = torch.exp(torch.clamp(total[:, :, None] - cum, -CLIP, CLIP)) * dtc  # [B, n, C, H]
    (W,) = _split(Bc[:, :, :, None, :] * wgt[..., None], split_bf16, pair=False)
    L = torch.einsum("bcshn,bcshp->bchnp", W, xc)  # [B, n, H, N, P]
    # -- stage 2: state passing ----------------------------------------------------
    S = state0.float()
    S_in = []
    for c in range(n):
        S_in.append(S)
        S = torch.exp(total[:, c])[..., None, None] * S + L[:, c]
    # -- stage 3: chunk outputs ----------------------------------------------------
    if n == 0:
        return x32.new_zeros(Bsz, 0, H, P).to(x.dtype), S
    S_in = torch.stack(S_in, dim=1)  # [B, n, H, N, P]
    CB = torch.einsum("bctn,bcsn->bcts", Cc, Bc)
    causal = torch.tril(torch.ones(C, C, dtype=torch.bool, device=x.device))
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B, n, t, s, H]
    pair = torch.exp(torch.clamp(diff.masked_fill(~causal[:, :, None], -CLIP), -CLIP, CLIP))
    scores = CB[..., None] * pair * dtc[:, :, None] * causal[:, :, None]  # [B, n, t, s, H]
    y = sum(torch.einsum("bctsh,bcshp->bcthp", s, xc)
            for s in _split(scores, split_bf16, pair=True))
    y_state = sum(torch.einsum("bctn,bchnp->bcthp", Cc, s)
                  for s in _split(S_in, split_bf16, pair=True))
    y = y + torch.exp(cum)[..., None] * y_state + D.float()[:, None] * xc
    return y.reshape(Bsz, n * C, H, P)[:, :T].to(x.dtype), S
