"""K2, the flash prefill kernel: its roofline bound over its device time in
the traced part of the window, in percent.  One call a layer per step that
prefills; a call's bound is the larger of the causal pairs' FLOPs at the
bf16 peak and its bytes (q, k, v, output once) at HBM bandwidth, over the
rows' own lengths (padding is no work)."""

from bench import yardstick as ys

KERNELS = ("flash_prefill_kernel", "flash_prefill_tc_kernel")


def read(run):
    if run.trace is None:
        return None
    L = run.cfg["num_hidden_layers"]
    bound = sum(L * ys.bound_s(*ys.flash_prefill_call(run.cfg, s.prefill_lens))
                for s in run.traced_steps() if s.prefill_lens)
    t = run.trace.kernel_seconds(KERNELS)
    if bound <= 0 or t <= 0:
        return None
    return 100.0 * bound / t
