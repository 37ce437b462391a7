"""Plain float32 reference of a dense decoder (Qwen3): GQA attention with
per-head RMSNorm on q and k (``model_type`` qwen3), rotary embeddings
(rotate-half, ``rope_theta``), SwiGLU FFN, RMSNorm, untied output head.

The forward pass runs the whole sequence at once, layer by layer over every
sequence given (the card holds one layer's float32 weights at a time), with
attention in blocks of queries.  ``quant="fp8"`` is the control: every
matmul's weight (per output channel) and input (per row) rounded to
float8 e4m3 first.
"""

from __future__ import annotations

import math
from typing import Callable, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from bench.yardstick import dims

Group = Tuple[str, List[str], Tuple[int, ...], str, object]

Q_BLOCK = 1024  # query rows per attention block


def attn_groups(hf: Mapping, layers: Sequence[int]) -> List[Group]:
    """The attention leaves of ``layers``, one draw per leaf:
    ``wq [d, H, hd]``, ``wk``/``wv [d, KV, hd]``, ``wo [H, hd, d]``."""
    L, d, H, KV, hd = dims(hf)
    lay = [f"layers.{i}." for i in layers]
    groups: List[Group] = [
        ("ln1", [p + "ln1" for p in lay], (d,), "f32", "norm"),
        ("ln2", [p + "ln2" for p in lay], (d,), "f32", "norm"),
        ("wq", [p + "attn.wq" for p in lay], (d, H, hd), "bf16", 1 / math.sqrt(d)),
        ("wk", [p + "attn.wk" for p in lay], (d, KV, hd), "bf16", 1 / math.sqrt(d)),
        ("wv", [p + "attn.wv" for p in lay], (d, KV, hd), "bf16", 1 / math.sqrt(d)),
        ("wo", [p + "attn.wo" for p in lay], (H, hd, d), "bf16", 1 / math.sqrt(H * hd)),
    ]
    if hf.get("model_type") == "qwen3":
        groups += [("q_norm", [p + "attn.q_norm" for p in lay], (hd,), "f32", "norm"),
                   ("k_norm", [p + "attn.k_norm" for p in lay], (hd,), "f32", "norm")]
    return groups


def mlp_groups(key: str, names: Sequence[str], d: int, f: int) -> List[Group]:
    """SwiGLU leaves under the prefixes ``names``: ``w_gate``/``w_up
    [d, f]``, ``w_down [f, d]``."""
    return [(f"{key}.w_gate", [n + "w_gate" for n in names], (d, f), "bf16", 1 / math.sqrt(d)),
            (f"{key}.w_up", [n + "w_up" for n in names], (d, f), "bf16", 1 / math.sqrt(d)),
            (f"{key}.w_down", [n + "w_down" for n in names], (f, d), "bf16", 1 / math.sqrt(f))]


def head_groups(hf: Mapping) -> List[Group]:
    d, V = hf["hidden_size"], hf["vocab_size"]
    groups: List[Group] = [("embed", ["embed"], (V, d), "bf16", 0.02),
                           ("final_norm", ["final_norm"], (d,), "f32", "norm")]
    if not hf.get("tie_word_embeddings"):
        groups.append(("unembed", ["unembed"], (d, V), "bf16", 0.02))
    return groups


def weight_groups(hf: Mapping) -> List[Group]:
    L, d = hf["num_hidden_layers"], hf["hidden_size"]
    return (head_groups(hf) + attn_groups(hf, range(L))
            + mlp_groups("mlp", [f"layers.{i}.mlp." for i in range(L)], d,
                         hf["intermediate_size"]))


# ---------------------------------------------------------------------------
# float32 building blocks
# ---------------------------------------------------------------------------


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` through float8 e4m3 with one scale per slice along ``dim``
    (the amax maps to 448), back in float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = 448.0 / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


class Linear:
    """Matmuls in float32, or through float8 e4m3 for the control."""

    def __init__(self, quant: Optional[str]):
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown quant {quant!r}")
        self.quant = quant

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        """A [K, N] weight in float32 (rounded per output column)."""
        w = w.float()
        return fp8_round(w, 0) if self.quant else w

    def __call__(self, x: torch.Tensor, w32: torch.Tensor) -> torch.Tensor:
        if self.quant:
            x = fp8_round(x, -1)
        return x @ w32


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * scale.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [T, heads, hd] at positions 0..T-1, rotate-half pairs (i, i + hd/2)."""
    T, hd = x.shape[0], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q [T, H, hd], k/v [T, KV, hd] -> [T, H, hd]; each query group reads
    its KV head."""
    T, H, hd = q.shape
    rep = H // k.shape[1]
    k = k.repeat_interleave(rep, dim=1).transpose(0, 1)  # [H, T, hd]
    v = v.repeat_interleave(rep, dim=1).transpose(0, 1)
    qh = q.transpose(0, 1) / math.sqrt(hd)
    out = torch.empty_like(qh)
    for s in range(0, T, Q_BLOCK):
        e = min(T, s + Q_BLOCK)
        sc = qh[:, s:e] @ k[:, :e].transpose(1, 2)  # [H, b, e]
        mask = torch.arange(e, device=q.device)[None, :] > torch.arange(s, e, device=q.device)[:, None]
        sc.masked_fill_(mask, float("-inf"))
        out[:, s:e] = torch.softmax(sc, dim=-1) @ v[:, :e]
    return out.transpose(0, 1)


def attention_layer(w: Mapping[str, torch.Tensor], i: int, hf: Mapping, lin: Linear,
                    hs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Layer ``i``'s attention output for each sequence's normed input."""
    L, d, H, KV, hd = dims(hf)
    p = f"layers.{i}.attn."
    wq = lin.weight(w[p + "wq"].reshape(d, H * hd))
    wk = lin.weight(w[p + "wk"].reshape(d, KV * hd))
    wv = lin.weight(w[p + "wv"].reshape(d, KV * hd))
    wo = lin.weight(w[p + "wo"].reshape(H * hd, d))
    eps, theta = hf["rms_norm_eps"], float(hf["rope_theta"])
    outs = []
    for h in hs:
        T = h.shape[0]
        q = lin(h, wq).view(T, H, hd)
        k = lin(h, wk).view(T, KV, hd)
        v = lin(h, wv).view(T, KV, hd)
        if p + "q_norm" in w:
            q = rms_norm(q, w[p + "q_norm"], eps)
            k = rms_norm(k, w[p + "k_norm"], eps)
        o = causal_attention(rope(q, theta), rope(k, theta), v)
        outs.append(lin(o.reshape(T, H * hd), wo))
    return outs


def swiglu(w: Mapping[str, torch.Tensor], prefix: str, lin: Linear,
           h: torch.Tensor) -> torch.Tensor:
    g = lin(h, lin.weight(w[prefix + "w_gate"]))
    u = lin(h, lin.weight(w[prefix + "w_up"]))
    return lin(F.silu(g) * u, lin.weight(w[prefix + "w_down"]))


def dense_ffn(w, i: int, hf: Mapping, lin: Linear, hs: List[torch.Tensor],
              seqs: Sequence[Mapping]) -> List[torch.Tensor]:
    """Layer ``i``'s SwiGLU over every sequence at once."""
    out = swiglu(w, f"layers.{i}.mlp.", lin, torch.cat(hs))
    return list(out.split([h.shape[0] for h in hs]))


FFN = Callable[[Mapping, int, Mapping, Linear, List[torch.Tensor], Sequence[Mapping]],
               List[torch.Tensor]]


@torch.no_grad()
def forward_logits(w: Mapping[str, torch.Tensor], hf: Mapping, seqs: Sequence[Mapping],
                   ffn: FFN, quant: Optional[str] = None) -> List[torch.Tensor]:
    """Each sequence ``{"tokens": LongTensor [T], "want": LongTensor}`` ->
    float32 logits [len(want), V] at the positions ``want``.  Matmuls in
    float32 with TF32 off (or the control's float8 rounding)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        lin = Linear(quant)
        eps = hf["rms_norm_eps"]
        embed = w["embed"]
        xs = [embed[s["tokens"].to(embed.device)].float() for s in seqs]
        for i in range(hf["num_hidden_layers"]):
            pre = f"layers.{i}."
            hs = [rms_norm(x, w[pre + "ln1"], eps) for x in xs]
            xs = [x + o for x, o in zip(xs, attention_layer(w, i, hf, lin, hs))]
            hs = [rms_norm(x, w[pre + "ln2"], eps) for x in xs]
            xs = [x + o for x, o in zip(xs, ffn(w, i, hf, lin, hs, seqs))]
        head = w["embed"].T if hf.get("tie_word_embeddings") else w["unembed"]
        head32 = lin.weight(head)
        last = torch.cat([x[s["want"].to(x.device)] for x, s in zip(xs, seqs)])
        logits = lin(rms_norm(last, w["final_norm"], eps), head32)
        return list(logits.split([len(s["want"]) for s in seqs]))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def logits_at(w: Mapping[str, torch.Tensor], hf: Mapping, seqs: Sequence[Mapping],
              quant: Optional[str] = None) -> List[torch.Tensor]:
    return forward_logits(w, hf, seqs, dense_ffn, quant)
