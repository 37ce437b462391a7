"""The window over the engine steps it ran, in milliseconds
(``NeoEngine.step``, host clock)."""


def read(run):
    if not run.win.steps:
        return None
    return run.win.seconds / len(run.win.steps) * 1e3
