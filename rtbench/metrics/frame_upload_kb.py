"""KB a frame that the port's packer copies to the card: its
``upload_bytes`` counter (`raytracinginoneweekendincuda_torch/utils/
tracing.py`, which counts only while a profiler records, so only in the
traced window) over the window's frames.  None where the port has no such
counter, or without device records (a run off the card)."""


def read(win):
    try:
        from raytracinginoneweekendincuda_torch.utils import tracing
    except ImportError:
        return None
    n = win.counts.get("frames")
    b = tracing.counters().get("upload_bytes")
    if not n or b is None or not win.device:
        return None
    return b / 1024 / n
