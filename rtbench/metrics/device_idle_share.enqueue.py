"""Share of the traced window (%) in which the card is idle and the host is
inside ``render()`` (``rt.render``) but neither packing nor reading
back: the frame's parameters, K1's launch, the epilogue, Python.
One of the four parts of ``device_idle_share.render`` (`_host_idle`);
None without the port's spans."""

from rtbench.metrics._host_idle import shares


def read(win):
    s = shares(win)
    return None if s is None else s["enqueue"]
