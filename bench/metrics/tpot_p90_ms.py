"""90th percentile, over every request that emitted two tokens or more
inside the window, of (last - first token time) / (tokens - 1) there, in
milliseconds (host clock)."""

from bench.window import percentile, tpot_samples


def read(run):
    p = percentile(tpot_samples(run.recs), 90)
    return None if p is None else p * 1e3
