"""Share of the traced window (%) in which the card is idle and the host is
inside the packer (``rt.pack``: the tables built and copied to the
card).
One of the four parts of ``device_idle_share.render`` (`_host_idle`);
None without the port's spans."""

from rtbench.metrics._host_idle import shares


def read(win):
    s = shares(win)
    return None if s is None else s["pack"]
