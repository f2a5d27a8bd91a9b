"""Generators of traffic, one module a kind, named by a mix's ``driver``
key.  A module defines ``Driver(cell, seed, device, traced)`` with:

- ``setup()``: every shape the cell's traffic uses, warmed up;
- ``window(seconds) -> t0``: the closed loop, until an item ends at or
  after ``t0 + seconds``; ``attempted`` and ``failed`` count its items;
- ``end_to_end(t0) -> {metric: value}``: the cell's end-to-end metrics;
- ``release()``: the program's state freed;
- ``readings(ref_world) -> [Reading]``: the comparison with the
  reference, after ``release()``;
- ``count(ref_world) -> dict``: the counts a traced run's readers take.
"""
