"""The yardstick of the roofline shares: the card's published peaks and
each kernel's operations and bytes, computed from shapes and counts that
the benchmark makes itself.  The peaks are a copy of the port's
``tools/common.py`` at port commit
f5f430408f621517b545c0351449e6c34668eb84; K1's operations count the
work of the reference's own BVH walk (`k1.py`).  Only a change to the
benchmark edits them."""
