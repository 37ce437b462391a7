"""Speculative-decoding drafters (the port's copy of the JAX package's
``core/spec.py``; SpecOffload-style, arXiv 2505.10259).

A drafter proposes up to K tokens per decode row; the engine verifies them
in one extra batched pass of the unchanged decode graph
(``NeoEngine._run_spec_chain``), which recomputes the logits serial decode
would give at each position, so greedy outputs are bitwise the ones of
non-speculative decode by construction and a rejection leaves the row at
its serial state (``docs/spec_decode.md``).

* :class:`NgramDrafter` (the default, no weights): prompt lookup.  The
  row's trailing ``n``-gram is matched against its own earlier tokens
  (prompt + generated) and the continuation of the most recent match is
  proposed.  Pure Python, the reference's code as it is.
* :class:`DraftModelDrafter`: a small stateless draft model (for example
  qwen3-0.6b drafting for qwen3-14b) rolls out K tokens greedily, each by
  re-prefilling the row's trailing window.  It never touches the KV pools.

Drafters are pure: ``propose(tokens, k)`` returns at most ``k`` token ids
and mutates nothing, so tests can stub them (a wrong-token stub forces the
rejection path; replaying a recorded serial output forces full accepts).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch


class NgramDrafter:
    """Prompt-lookup drafting: propose the continuation of the most recent
    earlier occurrence of the row's trailing ``n``-gram.

    Matching degrades gracefully: if the full ``n``-gram has no earlier
    occurrence, shorter suffixes down to a single token are tried.  Returns
    an empty list when nothing matches — the row then rides the verify
    chain for its free bonus token only (a depth-0 chain row).
    """

    def __init__(self, n: int = 3, min_n: int = 1):
        self.n = max(1, int(n))
        self.min_n = max(1, int(min_n))

    def propose(self, tokens: Sequence[int], k: int) -> List[int]:
        if k <= 0 or len(tokens) < self.min_n + 1:
            return []
        toks = list(tokens)
        for n in range(min(self.n, len(toks) - 1), self.min_n - 1, -1):
            tail = toks[-n:]
            # most recent earlier occurrence of the trailing n-gram
            for start in range(len(toks) - n - 1, -1, -1):
                if toks[start:start + n] == tail:
                    cont = toks[start + n:start + n + k]
                    if cont:
                        return cont
        return []


class DraftModelDrafter:
    """Greedy rollout from a small stateless draft model.

    Each of the K drafts prefills the last ``window`` tokens (at least 8) of
    the row's context as one ``[1, S]`` batch on the model's device, with
    the flash prefill kernel on the card (``impl="kernel"``; on the CPU its
    plain version), and takes the argmax there: one int comes back per
    draft.  No KV cache and no pool pages, so pool accounting, rollback and
    the bitwise argument are the n-gram drafter's.  ``prefills`` counts the
    model's prefill calls (each launches the kernel once per layer).

    The draft and target vocabularies must match (token ids are proposed
    verbatim); the qwen3 family satisfies this.
    """

    def __init__(self, model, *, window: int = 64, vocab_size: Optional[int] = None):
        self.model = model
        self.window = max(8, int(window))
        self.vocab_size = vocab_size
        self.prefills = 0

    def propose(self, tokens: Sequence[int], k: int) -> List[int]:
        if k <= 0 or not len(tokens):
            return []
        ctx = list(tokens)
        out: List[int] = []
        dev = self.model.device
        with torch.inference_mode():
            for _ in range(k):
                win = torch.tensor([ctx[-self.window:]], dtype=torch.long, device=dev)
                logits, _ = self.model.prefill(win, impl="kernel")
                self.prefills += 1
                tok = int(logits[0].argmax())
                if self.vocab_size is not None and not (0 <= tok < self.vocab_size):
                    break
                out.append(tok)
                ctx.append(tok)
        return out
