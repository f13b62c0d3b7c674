"""idle_share (%, device trace): the share of the traced window's wall in
which no kernel, copy or memset runs on the device: one minus the union of
the device intervals over the window."""


def read(run):
    w = run.window
    if w is None or w.seconds <= 0:
        return None
    return 100.0 * (1.0 - w.busy_seconds() / w.seconds)
