"""Host ms a frame in the port's packer: the summed length of the
``rt.pack`` spans in the traced window over its frames.  None without
the port's spans, or without device records (a run off the card, whose
times are not the cell's)."""


def read(win):
    n = win.counts.get("frames")
    t = [e - s for name, s, e in win.host if name == "rt.pack"]
    if not n or not t or not win.device:
        return None
    return 1e3 * sum(t) / n
