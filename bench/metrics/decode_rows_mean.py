"""Decode rows a step: the scheduler's device and offloaded decodes over the
window (``EngineStats`` deltas) over its steps."""


def read(run):
    if not run.win.steps:
        return None
    return (run.delta("device_decodes") + run.delta("offloaded_decodes")) / len(run.win.steps)
