"""PyTorch port against the JAX package at a larger frame (the slow tier):
the port's CPU ``mega2`` frame (K1's plain version) against JAX's CPU
``bruteforce`` frame at 96x54@8 on scenes 0, 3 and 9, with
``tests/test_mega2.py``'s bounds (scene 0's flip count taken as a share of
the frame: 6 of 128 pixels) and, on the Perlin and image scenes 3 and 9,
the statistical bound (more than 90% of pixels within 1e-2, mean below
2e-2).  Marked ``slow``: run with ``pytest -m slow
tests/test_torch_slow_parity.py``."""

import numpy as np
import pytest

from raytracinginoneweekendincuda_torch.models import scenes
from raytracinginoneweekendincuda_torch.ops.render import render
from raytracinginoneweekendincuda_torch.scene.compiler import compile_scene
from raytracinginoneweekendincuda_torch.utils.config import RenderConfig
from raytracinginoneweekendincuda_tpu.models import scenes as jscenes
from raytracinginoneweekendincuda_tpu.ops.render import render as jrender
from raytracinginoneweekendincuda_tpu.scene.compiler import (
    compile_scene as jcompile,
)
from raytracinginoneweekendincuda_tpu.utils.config import (
    RenderConfig as JConfig,
)
from torch_render_cases import check_bounds
from torch_threads import one_torch_thread  # noqa: F401

W, H, SPP = 96, 54, 8


def frame_gap(img, ref) -> str:
    diff = np.abs(img.astype(np.float64) - ref)
    n = diff.shape[0] * diff.shape[1]
    return (f"{int((diff.max(-1) > 1e-5).sum())} of {n} pixels above 1e-5, "
            f"{(diff.max(-1) < 1e-2).mean():.4f} within 1e-2, mean "
            f"{diff.mean():.3e}")


FAULT8 = ("ROADMAP.md fault 8: 256 pixels above 1e-5 where 6 of 128 allows "
          "243; JAX's own mega2 against its bruteforce has 254")


@pytest.mark.slow
@pytest.mark.parametrize("sid", (
    pytest.param(0, marks=pytest.mark.xfail(strict=True, reason=FAULT8)),
    3, 9))
def test_port_mega2_matches_jax_bruteforce_96x54(sid):
    scene, meta = compile_scene(scenes.build_scene(sid), W, H,
                                dtype=np.float32)
    img = render(scene, meta, RenderConfig(
        width=W, height=H, samples_per_pixel=SPP, engine="mega2"),
        device="cpu")
    jscene, jmeta = jcompile(jscenes.build_scene(sid), W, H,
                             dtype=np.float32)
    ref = np.asarray(jrender(jscene, jmeta, JConfig(
        width=W, height=H, samples_per_pixel=SPP, engine="bruteforce")))
    print(f"scene {sid} at {W}x{H}@{SPP}: {frame_gap(img, ref)}")
    check_bounds(sid, img, ref)


@pytest.mark.slow
def test_port_mega2_matches_jax_mega2_96x54_scene0():
    """Scene 0 at 96x54@8 against the JAX package's own engine, ``mega2``
    (Pallas interpret mode, ~20 s here), with the same bound; the JAX
    package's mega2-against-bruteforce flip count at this size is printed
    beside it (the reference's own engine gap, which the test above
    meets)."""
    scene, meta = compile_scene(scenes.build_scene(0), W, H,
                                dtype=np.float32)
    img = render(scene, meta, RenderConfig(
        width=W, height=H, samples_per_pixel=SPP, engine="mega2"),
        device="cpu")
    jscene, jmeta = jcompile(jscenes.build_scene(0), W, H, dtype=np.float32)
    jm, jb = (np.asarray(jrender(jscene, jmeta, JConfig(
        width=W, height=H, samples_per_pixel=SPP, engine=e)))
        for e in ("mega2", "bruteforce"))
    print(f"scene 0 at {W}x{H}@{SPP}: port mega2 vs JAX mega2 "
          f"{frame_gap(img, jm)}; JAX mega2 vs JAX bruteforce "
          f"{frame_gap(jm, jb)}")
    check_bounds(0, img, jm)


@pytest.mark.slow
def test_scene3_fd_check_against_jax_xla_replay():
    """validate_replay_gpu's scene-3 check at its configuration (64x48,
    K 8, every lane weighted by the ramp), on the JAX package's tape, rays
    and pixel counters, along the tool's direction.  In f64 the port's
    XLA replay's directional derivative equals the JAX package's within
    rel 1e-6.  In f32 the marble makes the derivative ill-conditioned:
    K4's (plain version) must lie within the tool's bound (rel 0.35) of
    the f64 value, and no further from it than JAX's own f32 XLA
    replay's.  The f32 FD estimates at eps 1e-3 are printed (ROADMAP.md
    fault 9)."""
    import jax
    import jax.numpy as jnp
    import torch

    from raytracinginoneweekendincuda_torch.ops import hit
    from raytracinginoneweekendincuda_torch.ops import replay as rp
    from raytracinginoneweekendincuda_torch.tools import (
        validate_replay_gpu as vr,
    )
    from raytracinginoneweekendincuda_tpu.ops import replay as jrp
    from raytracinginoneweekendincuda_tpu.ops.raygen import (
        generate_rays as jrays,
    )

    w, h, K, eps = vr.W, vr.H, vr.K, vr.FD_EPS
    js32, jm32 = jcompile(jscenes.build_scene(3), w, h, dtype=np.float32)
    js32 = jax.tree.map(jnp.asarray, js32)
    pix = jnp.arange(w * h, dtype=jnp.int32)
    o, d, t, pc = jrays(js32.camera, pix, jnp.uint32(0), w, h, vr.SEED)
    tape, _ = jrp.generate_tape(js32, jm32, o, d, t, pc, jnp.uint32(0),
                                max_bounces=K, t_min=vr.T_MIN)
    wgt = np.arange(w * h * 3, dtype=np.float32).reshape(-1, 3) * 1e-4
    v = np.random.default_rng(7).standard_normal(js32.sph_c0.shape)
    v = v / np.abs(v).sum()

    def jax_dd(dt):
        """jax.grad's directional derivative and the loss function."""
        js, jm = jcompile(jscenes.build_scene(3), w, h, dtype=dt)
        js = jax.tree.map(jnp.asarray, js)
        ray = [x.astype(dt) for x in (o, d, t)]

        def loss(c0):
            return (jrp.replay(js._replace(sph_c0=c0), jm, tape, *ray, pc,
                               jnp.uint32(0), max_bounces=K,
                               t_min=vr.T_MIN) * wgt.astype(dt)).sum()
        g = jax.grad(loss)(js.sph_c0)
        return float(jnp.sum(g * v.astype(dt))), loss, js.sph_c0

    jax64, _, _ = jax_dd(np.float64)
    jax32, loss32, c32 = jax_dd(np.float32)
    v32 = jnp.asarray(v, jnp.float32)
    jax_fd = (float(loss32(c32 + eps * v32))
              - float(loss32(c32 - eps * v32))) / (2 * eps)

    # the port on JAX's tape, rays and counters
    case = vr.replay_case(3, torch.device("cpu"))
    to = (lambda x, dt=torch.float32:
          torch.as_tensor(np.asarray(x).astype(np.float64), dtype=dt))
    po, pd, pt = to(o), to(d), to(t)
    case = case._replace(
        o=po, d=pd, tm=pt, pc=to(pc, case.pc.dtype),
        rays=torch.cat([po, pd, pt[:, None]], dim=1),
        tape=to(tape, case.tape.dtype))
    leaf = case.base.sph_c0.detach().clone().requires_grad_(True)
    g = torch.autograd.grad(
        (vr.radiance(case, "sph_c0", leaf, True) * to(wgt)).sum(), leaf)[0]
    k4 = float((g * to(v)).sum())
    s64, m64 = compile_scene(scenes.build_scene(3), w, h, dtype=np.float64)
    b64 = hit.scene_tensors(s64, torch.device("cpu"))
    leaf = b64.sph_c0.detach().clone().requires_grad_(True)
    r64 = rp.replay(b64._replace(sph_c0=leaf), m64, case.tape,
                    *(x.double() for x in (po, pd, pt)), case.pc, 0,
                    max_bounces=K, t_min=vr.T_MIN)
    g = torch.autograd.grad((r64 * to(wgt, torch.float64)).sum(), leaf)[0]
    port64 = float((g * to(v, torch.float64)).sum())
    port = vr.check_scene(3, "sph_c0", torch.device("cpu"), fd=True)

    def rel(a, b):
        return abs(a - b) / abs(b)
    print(f"scene 3 at {w}x{h}, K {K}, JAX's tape: f64 XLA replay AD port "
          f"{port64:.9e} JAX {jax64:.9e} (rel {rel(port64, jax64):.2e}); "
          f"f32 AD K4 {k4:.6e} (rel to f64 {rel(k4, jax64):.4f}), JAX XLA "
          f"{jax32:.6e} (rel to f64 {rel(jax32, jax64):.4f}); f32 FD at "
          f"eps {eps}: JAX {jax_fd:.5e} (rel to its AD "
          f"{rel(jax_fd, jax32) if jax_fd else float('inf'):.4f}); the "
          f"port's own tape: close {port['close']:.4f}, FD rel "
          f"{port['fd_rel']:.4f}, f64 FD rel {port['fd64_rel']:.4f}")
    assert rel(port64, jax64) <= 1e-6
    assert rel(k4, jax64) < vr.FD_REL_MAX
    assert rel(k4, jax64) <= rel(jax32, jax64)
    assert port["close"] == 1.0 and port["fd64_rel"] < vr.FD_REL_MAX
