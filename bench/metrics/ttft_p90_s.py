"""90th percentile, over every request due inside the window, of due time to
first token; a request still waiting when the window closes counts its wait
so far (host clock)."""

from bench.window import percentile, ttft_samples


def read(run):
    return percentile(ttft_samples(run.recs, run.win), 90)
