"""K1, the paged decode attention kernel: its roofline bound over its device
time in the traced part of the window, in percent.  One call a layer per
step with device decode rows; a call's bound is the larger of its FLOPs at
the bf16 peak and its bytes (q, output, each KV head's K and V once) at HBM
bandwidth.  Its time is every launch of the kernel and of its split-K
merge."""

from bench import yardstick as ys

KERNELS = ("paged_decode_kernel", "merge_partials_kernel")


def read(run):
    if run.trace is None:
        return None
    L = run.cfg["num_hidden_layers"]
    bound = sum(L * ys.bound_s(*ys.paged_decode_call(run.cfg, s.dev_ctx))
                for s in run.traced_steps() if s.dev_ctx)
    t = run.trace.kernel_seconds(KERNELS)
    if bound <= 0 or t <= 0:
        return None
    return 100.0 * bound / t
