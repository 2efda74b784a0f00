"""idle_share.<part>: percent of the traced stretch in which no kernel,
copy or set ran on the device. None without a trace or device time."""


def read(run):
    trace = run.trace
    if trace is None or not trace["busy_s"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
