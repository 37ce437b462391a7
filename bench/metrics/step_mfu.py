"""Model FLOPs the card ran in the window over the window at one H100's
bf16 peak, in percent.  Per token prefilled or decoded, 2 x the parameters
its matmuls run through (the routed experts at their top-k share); the
output head once per row of logits; attention 4 x layers x heads x head_dim
a query-key pair, for prefill rows (causal) and device decode rows.  Host
rows' attention runs on the CPU and is not counted; padding is not work."""

from bench import yardstick as ys


def read(run):
    hf = run.cfg
    per_tok, head, pair = ys.linear_flops_per_token(hf), ys.head_flops(hf), ys.attn_pair_flops(hf)
    flops = 0.0
    for s in run.win.steps:
        rows = len(s.dev_ctx) + len(s.host_ctx)
        flops += per_tok * (rows + sum(s.prefill_lens)) + head * (rows + len(s.prefill_lens))
        flops += pair * (sum(s.dev_ctx) + sum(ys.causal_pairs(n) for n in s.prefill_lens))
    return 100.0 * flops / (run.win.seconds * ys.H100_PEAK_FLOPS)
