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
