"""Reference scene builders, one module a scene, found by name
(`rtbench.spec.reference_scene`): each defines ``world() -> World``.
Frozen copies of the port's ``models/scenes.py`` builders (port commit
f5f430408f621517b545c0351449e6c34668eb84): the same placement stream
(numpy's default_rng(1984)) and draws in the same order."""
