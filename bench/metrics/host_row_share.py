"""Share of the window's decode rows whose attention ran on the host
(``EngineStats.offloaded_decodes`` over all decodes, deltas), in percent."""


def read(run):
    total = run.delta("device_decodes") + run.delta("offloaded_decodes")
    if total <= 0:
        return None
    return 100.0 * run.delta("offloaded_decodes") / total
