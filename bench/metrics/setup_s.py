"""Process start to window start: kernels built or loaded, weights drawn,
the engine and its pools built, the first wave filled (host clock)."""


def read(run):
    return run.setup_s
