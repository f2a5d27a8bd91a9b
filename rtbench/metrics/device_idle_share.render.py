"""Share of the traced window in which no kernel or copy runs on the card
(%), from the union of the profiler's device intervals; render cells."""


def read(win):
    if not win.device:
        return None
    return 100.0 * win.idle_share()
