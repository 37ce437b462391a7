"""Plain float32 reference of a DeepSeek-MoE decoder: the dense decoder's
attention (MHA here, no q/k norm), a SwiGLU FFN in the first
``first_k_dense_replace`` layers, and after them a router over
``n_routed_experts`` fine-grained experts (top ``num_experts_per_tok`` by
router logit; their gates the router's softmax probabilities, renormalised
over the top ones where ``norm_topk_prob`` says so) plus ``n_shared_experts``
shared ones run as one SwiGLU of their summed width.

Capacity is the program's semantics, worked out again here: a prompt's
prefill is one batch row of the padded length ``S_pad`` (the longest
prefill of its batch rounded up to 16 x 2^i), each expert keeps at most
``ceil(S_pad x top_k x capacity_factor / n_routed_experts)`` of the row's
slots in token-major, then k, order, and a dropped slot adds nothing.  A
decoded token is a row of its own and keeps all its slots.
"""

from __future__ import annotations

import math
from typing import List, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F

from bench.reference import dense
from bench.reference.dense import Group, Linear, attn_groups, head_groups, mlp_groups
from bench.yardstick import is_moe_layer

# A prompt's result depends on the batch it was prefilled in (its capacity):
# each compared sequence carries ``batch_len``, and a request whose prefill
# was replayed after a preemption cannot be compared.
NEEDS_BATCH_LEN = True


def padded_len(n: int) -> int:
    """The prefill batch's padded length: the smallest 16 x 2^i >= n."""
    b = 16
    while b < n:
        b *= 2
    return b


def capacity(s_pad: int, hf: Mapping, capacity_factor: float) -> int:
    k, E = hf["num_experts_per_tok"], hf["n_routed_experts"]
    return max(int(math.ceil(s_pad * k * capacity_factor / E)), 1)


def weight_groups(hf: Mapping) -> List[Group]:
    L, d = hf["num_hidden_layers"], hf["hidden_size"]
    E, ff = hf["n_routed_experts"], hf["moe_intermediate_size"]
    moe_layers = [i for i in range(L) if is_moe_layer(hf, i)]
    dense_layers = [i for i in range(L) if not is_moe_layer(hf, i)]
    pre = [f"layers.{i}.moe." for i in moe_layers]
    groups = head_groups(hf) + attn_groups(hf, range(L))
    groups += mlp_groups("mlp", [f"layers.{i}.mlp." for i in dense_layers], d,
                         hf["intermediate_size"])
    groups += [
        ("router", [p + "router" for p in pre], (d, E), "f32", 1 / math.sqrt(d)),
        ("experts.w_gate", [p + "w_gate" for p in pre], (E, d, ff), "bf16", 1 / math.sqrt(d)),
        ("experts.w_up", [p + "w_up" for p in pre], (E, d, ff), "bf16", 1 / math.sqrt(d)),
        ("experts.w_down", [p + "w_down" for p in pre], (E, ff, d), "bf16", 1 / math.sqrt(ff)),
    ]
    if hf.get("n_shared_experts"):
        groups += mlp_groups("shared", [p + "shared." for p in pre], d,
                             ff * hf["n_shared_experts"])
    return groups


def _keep_mask(idx: torch.Tensor, seqs: Sequence[Mapping], lens: Sequence[int],
               hf: Mapping, capacity_factor: float) -> torch.Tensor:
    """[N, k] slots kept: each sequence's prompt positions under its row's
    capacity, its decoded positions all."""
    E = hf["n_routed_experts"]
    keep = torch.ones_like(idx, dtype=torch.bool)
    off = 0
    for s, n in zip(seqs, lens):
        P = s["prompt_len"]
        flat = idx[off:off + P].reshape(-1)
        onehot = F.one_hot(flat, E)
        pos = (onehot.cumsum(0) - onehot).gather(1, flat[:, None])[:, 0]
        C = capacity(padded_len(s["batch_len"]), hf, capacity_factor)
        keep[off:off + P] = (pos < C).view(P, -1)
        off += n
    return keep


def make_ffn(capacity_factor: float):
    def moe_ffn(w, i: int, hf: Mapping, lin: Linear, hs: List[torch.Tensor],
                seqs: Sequence[Mapping]) -> List[torch.Tensor]:
        if not is_moe_layer(hf, i):
            return dense.dense_ffn(w, i, hf, lin, hs, seqs)
        p = f"layers.{i}.moe."
        lens = [h.shape[0] for h in hs]
        h = torch.cat(hs)
        logits = h @ w[p + "router"].float()  # the router stays float32
        probs = torch.softmax(logits, dim=-1)
        gates, idx = torch.topk(probs, hf["num_experts_per_tok"], dim=-1, sorted=True)
        if hf["norm_topk_prob"]:
            gates = gates / gates.sum(dim=-1, keepdim=True)
        keep = _keep_mask(idx, seqs, lens, hf, capacity_factor)
        y = dense.swiglu(w, p + "shared.", lin, h) if hf.get("n_shared_experts") else \
            torch.zeros_like(h)
        for e in range(hf["n_routed_experts"]):
            tok, slot = ((idx == e) & keep).nonzero(as_tuple=True)
            if tok.numel() == 0:
                continue
            g = lin(h[tok], lin.weight(w[p + "w_gate"][e]))
            u = lin(h[tok], lin.weight(w[p + "w_up"][e]))
            ye = lin(F.silu(g) * u, lin.weight(w[p + "w_down"][e]))
            y.index_add_(0, tok, ye * gates[tok, slot, None])
        return list(y.split(lens))
    return moe_ffn


def logits_at(w: Mapping[str, torch.Tensor], hf: Mapping, seqs: Sequence[Mapping],
              quant: Optional[str] = None) -> List[torch.Tensor]:
    """Each sequence also carries ``prompt_len`` and ``batch_len`` (the
    longest prefill of the batch it was prefilled in); the capacity factor
    is the configuration's ``assumed.capacity_factor``."""
    ffn = make_ffn(float(hf["assumed"]["capacity_factor"]))
    return dense.forward_logits(w, hf, seqs, ffn, quant)
