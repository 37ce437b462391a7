"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, a sample of
the requests the program finished, drawn from the run seed and holding the
longest one (and the request with the most tokens decoded in host lanes,
where there is one), eight requests where the reference's token budget
holds them, goes through the plain reference: one float32 forward pass
over each prompt and its served tokens.  The number compared is the widest
gap by which a served token's reference logit lies below the reference's
best at its position (``max_logit_gap``).  Greedy decoding in a lower
precision picks a token whose gap is its logit error or less; a wrong token
from a broken path lies far below.

The control (``control_gap``) is the reference computed through float8 e4m3
(the step below the configuration's bfloat16): at each position of the same
sequences, the gap of the token the control ranks first.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from bench import weights as weights_lib
from bench.window import Rec

MAX_REQUESTS = 8
MAX_SEQ_TOKENS = 16384  # reference tokens (prompts + served) a sample may hold


def choose_sample(recs: Mapping[int, Rec], seed: int, needs_batch_len: bool) -> List[Rec]:
    """The longest finished request, the request with the most tokens
    decoded in host lanes (its tokens so far, finished or not: a served
    token is final), then finished ones in an order drawn from the seed."""
    served = [r for _, r in sorted(recs.items()) if r.tokens]
    if needs_batch_len:
        served = [r for r in served if not r.preempted and r.batch_len > 0]
    done = [r for r in served if r.finished is not None]
    if not done:
        return []
    pick = [max(done, key=lambda r: (len(r.tokens), -r.rid))]
    hosted = max(served, key=lambda r: (r.host_tokens, r.finished is not None, -r.rid))
    if hosted.host_tokens and hosted is not pick[0]:
        pick.append(hosted)
    rng = np.random.default_rng([seed & (2**64 - 1), 4])
    for i in rng.permutation(len(done)):
        if len(pick) >= MAX_REQUESTS:
            break
        r = done[int(i)]
        held = sum(len(p.prompt) + len(p.tokens) for p in pick)
        if r not in pick and held + len(r.prompt) + len(r.tokens) <= MAX_SEQ_TOKENS:
            pick.append(r)
    return pick


def sequences(sample: Sequence[Rec]) -> List[Dict]:
    out = []
    for r in sample:
        P, n = len(r.prompt), len(r.tokens)
        out.append({"tokens": torch.tensor(r.prompt + r.tokens[:-1], dtype=torch.long),
                    "want": torch.arange(P - 1, P - 1 + n),
                    "served": torch.tensor(r.tokens, dtype=torch.long),
                    "prompt_len": P, "batch_len": r.batch_len})
    return out


def _gaps(logits: Sequence[torch.Tensor], chosen: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per position: best reference logit minus the chosen token's."""
    out = []
    for lg, tok in zip(logits, chosen):
        tok = tok.to(lg.device)
        out.append((lg.max(dim=-1).values - lg.gather(1, tok[:, None])[:, 0]).cpu())
    return torch.cat(out)


def reference_logits(ref, cfg: Mapping, seed: int, seqs: Sequence[Dict], device,
                     quant: Optional[str] = None) -> List[torch.Tensor]:
    w = weights_lib.make(ref.weight_groups(cfg), seed, device)
    return ref.logits_at(w, cfg, seqs, quant=quant)


def program_gap(ref_logits: Sequence[torch.Tensor], seqs: Sequence[Dict]) -> Dict[str, float]:
    gaps = _gaps(ref_logits, [s["served"] for s in seqs])
    agree = np.mean([float((lg.argmax(-1).cpu() == s["served"]).float().mean())
                     for lg, s in zip(ref_logits, seqs)])
    return {"max_logit_gap": float(gaps.max()), **_spread(gaps, seqs),
            "argmax_agree": float(agree), "tokens_compared": int(gaps.numel())}


def _spread(gaps: torch.Tensor, seqs: Sequence[Dict]) -> Dict[str, float]:
    """The mean gap, the largest of each request's own mean gap (so that one
    bad request stands out of the sample), and the widest gap at the
    prefill's token and after it."""
    lens = [len(s["want"]) for s in seqs]
    first = torch.zeros(len(gaps), dtype=torch.bool)
    first[np.cumsum([0] + lens[:-1])] = True
    later = gaps[~first]
    return {"mean_logit_gap": float(gaps.mean()),
            "request_mean_gap_max": max(float(g.mean()) for g in gaps.split(lens)),
            "first_token_max_gap": float(gaps[first].max()),
            "decode_max_gap": float(later.max()) if len(later) else 0.0}


def control_gap(ref_logits: Sequence[torch.Tensor],
                ctrl_logits: Sequence[torch.Tensor]) -> Dict[str, float]:
    gaps = _gaps(ref_logits, [c.argmax(dim=-1) for c in ctrl_logits])
    seqs = [{"want": c} for c in ctrl_logits]
    return {"max_logit_gap": float(gaps.max()), **_spread(gaps, seqs)}
