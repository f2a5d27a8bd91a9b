"""Share of the window's frames whose K1 launch walked the sphere tree (%):
the port's ``k1_tree_launches`` counter (`raytracinginoneweekendincuda_
torch/ops/mega2.py::render_radiance_cuda`, counted only while a profiler
records, so only in the traced window) over the window's frames.  None
where the port has no sphere tree (no ``tree_launches`` on K1's wrapper),
or without device records (a run off the card)."""


def read(win):
    try:
        from raytracinginoneweekendincuda_torch.ops import mega2
        from raytracinginoneweekendincuda_torch.utils import tracing
    except ImportError:
        return None
    n = win.counts.get("frames")
    if not n or not win.device \
            or not hasattr(mega2.render_radiance_cuda, "tree_launches"):
        return None
    return 100.0 * tracing.counters().get("k1_tree_launches", 0) / n
