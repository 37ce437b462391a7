"""Output tokens a second: every token emitted inside the window over the
window's seconds (host clock)."""


def read(run):
    return run.win.tokens / run.win.seconds
