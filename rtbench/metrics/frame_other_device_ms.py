"""Device ms a frame in everything but K1 (uploads, epilogue, u8 cast,
readback copy), from the profiler's trace of the window."""

KERNEL = "mega2_render_kernel"


def read(win):
    n = win.counts.get("frames")
    if not n or not win.device:
        return None
    return 1e3 * (win.seconds() - win.seconds(KERNEL)) / n
