"""Rows a lane-bounce that K1 runs outside its sphere tree: the port's
counters of the rows its loops run over on every lane-bounce, padded as
K1 runs them (`raytracinginoneweekendincuda_torch/ops/mega2.py::
_pack_tables`: ``k1_tree_prefix_rows``, ``k1_loose_quad_rows``,
``k1_slab_rows``, ``k1_media``, counted a pack, only while a profiler
records), over the launches that walked the tree (``k1_tree_launches``).
None where the port has no such counters or no tree launch, or without
device records (a run off the card)."""

ROWS = ("k1_tree_prefix_rows", "k1_loose_quad_rows", "k1_slab_rows",
        "k1_media")


def read(win):
    try:
        from raytracinginoneweekendincuda_torch.utils import tracing
    except ImportError:
        return None
    c = tracing.counters()
    n = c.get("k1_tree_launches")
    if not n or not win.device or any(k not in c for k in ROWS):
        return None
    return sum(c[k] for k in ROWS) / n
