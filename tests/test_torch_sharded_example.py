"""PyTorch port: ``examples/sharded_render.py`` at world 1 on the CPU (no
launcher: the one-rank mesh), its PPM against the one-device render's."""

import numpy as np

from raytracinginoneweekendincuda_torch.core.image import write_ppm
from raytracinginoneweekendincuda_torch.examples import sharded_render
from raytracinginoneweekendincuda_torch.models import scenes
from raytracinginoneweekendincuda_torch.ops.render import render
from raytracinginoneweekendincuda_torch.scene.compiler import compile_scene
from raytracinginoneweekendincuda_torch.utils.config import RenderConfig
from torch_threads import one_torch_thread  # noqa: F401


def test_sharded_example_at_world_one(tmp_path, capsys, monkeypatch):
    for k in ("MASTER_ADDR", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    out = tmp_path / "sharded.ppm"
    assert sharded_render.main(["--device", "cpu", "--width", "32",
                                "--height", "16", "--spp", "4", "--out",
                                str(out)]) == 0
    text = capsys.readouterr().out
    assert "ranks: 1 on cpu, mesh px=1 sp=1" in text
    scene, meta = compile_scene(scenes.build_scene(4), 32, 16,
                                dtype=np.float32)
    ref = render(scene, meta, RenderConfig(width=32, height=16,
                                           samples_per_pixel=4,
                                           engine="mega2"), device="cpu")
    write_ppm(str(tmp_path / "ref.ppm"), ref)
    assert out.read_bytes() == (tmp_path / "ref.ppm").read_bytes()
