"""The JAX package's TPU probes (``tools/probe_*.py``), ported as Hopper
micro-benchmarks: ``probe_pair`` (the render kernel's sphere-pair loop),
``probe_intmul`` (pcg4d's integer multiplies) and ``probe_mosaic`` (the
gathers, loops, dots and trig a kernel's design rests on).  Each is a
``python -m`` entry point that runs on the card unless given
``--device cpu``, which runs the plain PyTorch versions."""
