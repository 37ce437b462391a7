"""The device lane's prefill seconds over the window
(``EngineStats.lane_busy_time["prefill"]`` delta), in percent."""


def read(run):
    return 100.0 * run.lane_delta("prefill") / run.win.seconds
