"""The yardstick of the roofline shares: the card's published peaks and
each kernel's operations and bytes, computed from shapes and counts that
the benchmark makes itself.  Frozen copies of the port's
``tools/common.py`` (peaks, ``bound``) and ``tools/lane_share.py``
(``pair_ops``, ``k1_bound``) at port commit
f5f430408f621517b545c0351449e6c34668eb84; not edited afterwards."""
