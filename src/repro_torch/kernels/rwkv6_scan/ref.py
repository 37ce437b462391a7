"""Plain PyTorch version of the chunked RWKV6 (Finch) recurrence: the same
function as the CUDA kernel in ``csrc/rwkv6_scan.cu`` and the JAX package's
``rwkv6_chunked_ref``.  The wrapper uses it for CPU tensors; the tests and
``chip_smoke.py`` hold the kernel to it on the card.

Per head (key dim j, value dim i), with a data-dependent decay w_t in (0, 1):

    y_t[i]   = sum_j r_t[j] * (S[j, i] + u[j] * k_t[j] * v_t[i])
    S[j, i] <- w_t[j] * S[j, i] + k_t[j] * v_t[i]

computed a chunk of tokens at a time with log-space pair decays clipped at
±60.  Unlike the reference, any T is taken: the tail is padded with w = 1
and r = k = v = 0, which adds nothing to y or S and decays nothing.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

CLIP = 60.0


def rwkv6_chunked(
    r: torch.Tensor,  # [B, T, H, N]
    k: torch.Tensor,  # [B, T, H, N]
    v: torch.Tensor,  # [B, T, H, N]
    w: torch.Tensor,  # [B, T, H, N] decay in (0, 1)
    u: torch.Tensor,  # [H, N] bonus of the current token
    state0: torch.Tensor,  # [B, H, N(key), N(value)]
    chunk: int = 16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y [B, T, H, N] in r's dtype, final state [B, H, N, N] f32)."""
    B, T, H, N = r.shape
    C = chunk
    pad = (-T) % C
    r32, k32, v32, w32 = (a.float() for a in (r, k, v, w))
    if pad:
        tail = (0, 0, 0, 0, 0, pad)
        r32, k32, v32 = (F.pad(a, tail) for a in (r32, k32, v32))
        w32 = F.pad(w32, tail, value=1.0)
    n = (T + pad) // C

    def chunks(a):
        return a.reshape(B, n, C, H, N)

    rc, kc, vc = chunks(r32), chunks(k32), chunks(v32)
    logw = chunks(torch.log(w32.clamp_min(1e-38)))
    u32 = u.float()
    below = torch.tril(torch.ones(C, C, dtype=torch.bool, device=r.device), diagonal=-1)
    S = state0.float()
    ys = []
    for c in range(n):
        rt, kt, vt, lw = rc[:, c], kc[:, c], vc[:, c], logw[:, c]  # [B, C, H, N]
        b = torch.cumsum(lw, dim=1)  # inclusive log decay from the chunk start
        b_excl = b - lw  # decay applied to the state before step t
        y_state = torch.einsum("bchj,bhji->bchi", rt * torch.exp(b_excl), S)
        pair = torch.exp(torch.clamp(b_excl[:, :, None] - b[:, None, :], -CLIP, CLIP))
        scores = torch.einsum("bthj,btshj,bshj->bths", rt, pair, kt)  # [B, t, H, s]
        scores = scores * below[None, :, None, :]
        y_intra = torch.einsum("bths,bshi->bthi", scores, vt)
        y_u = torch.einsum("bthj,hj,bthj->bth", rt, u32, kt)[..., None] * vt
        ys.append(y_state + y_intra + y_u)
        total = b[:, -1]  # [B, H, N]
        k_dec = kt * torch.exp(torch.clamp(total[:, None] - b, -CLIP, CLIP))
        S = torch.exp(total)[..., None] * S + torch.einsum("bshj,bshi->bhji", k_dec, vt)
    y = torch.cat(ys, dim=1)[:, :T] if ys else r32.new_zeros(B, 0, H, N)
    return y.to(r.dtype), S


STATE_CHUNK = 64  # tokens per chunk between state hand-offs in the kernel
SUB_CHUNK = 16  # tokens per sub-chunk whose pair decays the kernel forms exactly


def _split(a: torch.Tensor, split_bf16: bool):
    """The operand terms a product of the kernel's bf16 path takes for the
    f32 ``a``: itself (f32 path) or a bf16 hi + lo pair, in f32 so that the
    products accumulate in f32 as the tensor cores do."""
    if not split_bf16:
        return [a]
    hi = a.to(torch.bfloat16).float()
    return [hi, (a - hi).to(torch.bfloat16).float()]


def _split_product(eq: str, a: torch.Tensor, b: torch.Tensor, split_bf16: bool,
                   single: bool = False) -> torch.Tensor:
    """``einsum(eq, a, b)`` as the kernel forms it: both operands split, three
    products hi.hi + hi.lo + lo.hi (the lo.lo term is below f32 rounding);
    ``single`` splits ``a`` only (``b`` is an exact bf16 input)."""
    if not split_bf16:
        return torch.einsum(eq, a, b)
    (ah, al), (bh, bl) = _split(a, True), _split(b, True)
    if single:
        return torch.einsum(eq, ah, b) + torch.einsum(eq, al, b)
    return torch.einsum(eq, ah, bh) + torch.einsum(eq, ah, bl) + torch.einsum(eq, al, bh)


def rwkv6_staged(
    r: torch.Tensor,  # [B, T, H, N]
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,  # decay in (0, 1)
    u: torch.Tensor,  # [H, N]
    state0: torch.Tensor,  # [B, H, N(key), N(value)]
    split_bf16: bool = False,
    chunk: int = STATE_CHUNK,
    sub: int = SUB_CHUNK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's three stages in plain PyTorch (tests only), with state
    passed every ``chunk`` tokens.  Per channel, the log decays are summed
    within each ``sub``-token sub-chunk g: the local inclusive prefix ``bl``,
    its exclusive form ``ble`` (0 at the sub-chunk start) and the sub-chunk
    total ``cg``.  Every decay exponent is built from these, so no difference
    of prefix sums spans more than one sub-chunk (a longer one cancels
    digits in f32 once w nears its 1e-38 floor):

    1. chunk states, every chunk at once: ``L_c = (k * exp(clip(cg[g_s] -
       bl_s + sum_{g > g_s} cg[g])))^T v`` and ``total = sum_g cg[g]``;
    2. state passing, the only walk over chunks: ``S_in[c+1] =
       exp(total_c) * S_in[c] + L_c`` (per key row) from ``state0``;
    3. chunk outputs, every chunk at once: ``y = scores v + (r * exp(sum_{g <
       g_t} cg[g] + ble_t)) S_in``.  Scores inside a sub-chunk are formed
       pair by pair, ``sum_j r_t k_s exp(clip(ble_t - bl_s))`` for s < t, with
       the ``u`` bonus at s == t; for s in an earlier sub-chunk they are the
       product ``(r_t * exp(clip(ble_t))) . (k_s * exp(clip(cg[g_s] - bl_s))
       * exp(clip(sum_{g_s < g < g_t} cg[g])))``.  Every exponent is <= 0.

    ``split_bf16`` rounds every f32 product operand to a bf16 hi + lo pair
    as the kernel's bf16 path does (three products per pair of split
    operands; v, a bf16 input, exact).  Same result as :func:`rwkv6_chunked`
    up to f32 rounding (pair decays below e^-60 are clipped there)."""
    B, T, H, N = r.shape
    C, G = chunk, chunk // sub
    pad = (-T) % C
    r32, k32, v32, w32 = (a.float() for a in (r, k, v, w))
    if pad:
        tail = (0, 0, 0, 0, 0, pad)
        r32, k32, v32 = (F.pad(a, tail) for a in (r32, k32, v32))
        w32 = F.pad(w32, tail, value=1.0)
    n = (T + pad) // C
    if split_bf16:  # the kernel's operands r, k, v are bf16
        r32, k32, v32 = (a.to(torch.bfloat16).float() for a in (r32, k32, v32))
    rc, kc, vc = (a.reshape(B, n, G, sub, H, N) for a in (r32, k32, v32))
    lw = torch.log(w32.clamp_min(1e-38)).reshape(B, n, G, sub, H, N)
    bl = torch.cumsum(lw, dim=3)  # inclusive, from the sub-chunk start
    ble = F.pad(bl[:, :, :, :-1], (0, 0, 0, 0, 1, 0))  # exclusive: 0 at the start
    cg = bl[:, :, :, -1]  # [B, n, G, H, N] sub-chunk totals
    tail_dec = cg[:, :, :, None] - bl  # sum of log w after s in its sub-chunk

    def cg_sum(lo, hi):  # sum_{lo <= g < hi} cg[g], in order of g
        acc = torch.zeros_like(cg[:, :, 0])
        for g in range(lo, hi):
            acc = acc + cg[:, :, g]
        return acc

    # -- stage 1: chunk states -----------------------------------------------------
    total = cg_sum(0, G)  # [B, n, H, N]
    k_dec = torch.stack([kc[:, :, g] * torch.exp(torch.clamp(
        tail_dec[:, :, g] + cg_sum(g + 1, G)[:, :, None], -CLIP, CLIP)) for g in range(G)], 2)
    L = _split_product("bcshj,bcshi->bchji", k_dec.reshape(B, n, C, H, N),
                       vc.reshape(B, n, C, H, N), split_bf16, single=True)
    # -- stage 2: state passing ----------------------------------------------------
    S = state0.float()
    S_in = []
    for c in range(n):
        S_in.append(S)
        S = torch.exp(total[:, c])[..., None] * S + L[:, c]
    if n == 0:
        return r32.new_zeros(B, 0, H, N).to(r.dtype), S
    S_in = torch.stack(S_in, dim=1)  # [B, n, H, N, N]
    # -- stage 3: chunk outputs ----------------------------------------------------
    scores = r32.new_zeros(B, n, C, C, H)  # [B, n, t, s, H]
    below = torch.tril(torch.ones(sub, sub, dtype=torch.bool, device=r.device), diagonal=-1)
    rd = []
    for g in range(G):
        t = slice(g * sub, (g + 1) * sub)
        rt, kt = rc[:, :, g], kc[:, :, g]
        pair = torch.exp(torch.clamp(ble[:, :, g, :, None] - bl[:, :, g, None], -CLIP, CLIP))
        intra = torch.einsum("bcthj,bctshj,bcshj->bctsh", rt, pair, kt) * below[:, :, None]
        diag = torch.einsum("bcthj,hj,bcthj->bcth", rt, u.float(), kt)
        scores[:, :, t, t] = intra + torch.diag_embed(diag.transpose(-1, -2)).permute(0, 1, 3, 4, 2)
        if g:
            rq = rt * torch.exp(torch.clamp(ble[:, :, g], -CLIP, CLIP))
            # the s factor as the kernel forms it: k_s exp(cg[gs] - bl_s) as
            # its operand (hi + lo), times the whole sub-chunks in between
            kq = torch.cat([sum(_split(kc[:, :, gs] * torch.exp(torch.clamp(
                tail_dec[:, :, gs], -CLIP, CLIP)), split_bf16)) * torch.exp(torch.clamp(
                    cg_sum(gs + 1, g), -CLIP, CLIP))[:, :, None]
                for gs in range(g)], dim=2)
            scores[:, :, t, :g * sub] = _split_product("bcthj,bcshj->bctsh", rq, kq, split_bf16)
        rd.append(rt * torch.exp(cg_sum(0, g)[:, :, None] + ble[:, :, g]))
    y = _split_product("bctsh,bcshi->bcthi", scores, vc.reshape(B, n, C, H, N), split_bf16,
                       single=True)
    y = y + _split_product("bcthj,bchji->bcthi", torch.cat(rd, dim=2), S_in, split_bf16)
    return y.reshape(B, n * C, H, N)[:, :T].to(r.dtype), S
