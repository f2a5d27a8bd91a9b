"""The reference against the port's plain K1 version (CPU, tiny size),
and the control: the reference in bfloat16 in the program's place comes
out not correct."""

import numpy as np
import pytest
import torch

from raytracinginoneweekendincuda_torch.models import scenes
from raytracinginoneweekendincuda_torch.ops import mega2
from raytracinginoneweekendincuda_torch.ops.render import finalize
from raytracinginoneweekendincuda_torch.scene.compiler import compile_scene
from raytracinginoneweekendincuda_torch.utils.config import RenderConfig
from rtbench.control import control
from rtbench.reference import tracer
from rtbench.reference.scenes import book1_final, bouncing_spheres

from .conftest import gpu_device

WORLDS = {"book1_final": book1_final, "bouncing_spheres": bouncing_spheres}


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_reference_equals_the_plain_k1_version(name):
    W, H, spp, seed = 20, 12, 2, 2**32 - 7
    sc, meta = compile_scene(getattr(scenes, name)(), W, H, dtype=np.float32)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=spp, seed=seed)
    tab = mega2.pack_mega2_tables(sc, meta, "cpu")
    pix = torch.arange(W * H, dtype=torch.int32)
    port = mega2.render_radiance_plain(tab, pix, mega2.frame_params(sc, cfg))
    fr = tracer.Frame(WORLDS[name].world(), W, H, 50, "cpu")
    ref, bounces = tracer.radiance(fr, pix, [seed], spp)
    ref, bounces = ref[0], bounces[0]
    assert torch.equal(port, ref)
    assert torch.equal(finalize(port, spp, True, True),
                       tracer.to_u8(ref, spp))
    assert int(bounces.min()) >= spp


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_is_not_correct(tiny_root, seed):
    for wl in ("book1_final.final_render", "bouncing_spheres.preview"):
        res = control(wl, seed, 4, root=tiny_root, device="cpu")
        assert res["correct"] is False
        assert res["check"]["u8_mean_abs"]["value"] > 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("workload,frames", [
    ("book1_final.final_render", 40), ("bouncing_spheres.preview", 1400)])
def test_control_is_not_correct_on_the_card_at_the_cell_size(workload,
                                                              frames):
    dev = gpu_device()
    for seed in (1, 2, 3):
        assert control(workload, seed, frames, device=dev)["correct"] is False
