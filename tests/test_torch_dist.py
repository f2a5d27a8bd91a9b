"""PyTorch port: the sharded render and the mesh train steps in real
``torch.distributed`` worlds (gloo, on the CPU).

This file is also its own child: ``python test_torch_dist.py OUT WORLD
RANK N_SP INIT`` runs one rank (module level imports only the port), which
joins the world over gloo (`parallel/distributed.initialize`), builds the
(px, sp) mesh, and saves to ``OUT/rank{RANK}.npz``:

* the mega2 frame of quads at 24x12@4 (`render_sharded`);
* one taped general step at K 8 on perlin_spheres 16x8@2, SGD 1e-2 (the
  marble makes geometry gradients non-zero);
* one mega2 step on quads 16x8@2, K 3, Adam 1e-2.

Three worlds run (shapes (2, 1), (1, 2) and (2, 2)), a fourth is the CLI
under ``torch.distributed.run``.  The frames must be bit-identical to the
in-process combine of `tests/test_torch_parallel.py` (and, at sp = 1, to
the one-device render); the steps must match the one-device steps with
the JAX package's bounds (``tests/test_parallel.py``: the marble taped
step's relative update bound, the mega2 step's loss rel 1e-6 and leaves
3e-6), and every rank must hold the same leaves.  The JAX package's own
mega2 mesh step is the reference at (2, 2) only: its interpret-mode
compile takes 40-80 s a mesh shape on a CPU.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from raytracinginoneweekendincuda_torch.models import scenes
from raytracinginoneweekendincuda_torch.ops.render import render
from raytracinginoneweekendincuda_torch.parallel import distributed, train
from raytracinginoneweekendincuda_torch.parallel import render as prender
from raytracinginoneweekendincuda_torch.scene.compiler import compile_scene
from raytracinginoneweekendincuda_torch.utils.config import RenderConfig
from torch_threads import one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FRAME = (4, 24, 12, 4)            # scene, W, H, spp (mega2)
TAPED = (3, 16, 8, 2, 8)          # perlin_spheres, W, H, spp, K
MEGA2 = (4, 16, 8, 2, 3)          # quads, W, H, spp, K
SHAPES = [(2, 1), (1, 2), (2, 2)]
TIMEOUT = 300


def frame_case():
    sid, W, H, spp = FRAME
    scene, meta = compile_scene(scenes.build_scene(sid), W, H,
                                dtype=np.float32)
    return scene, meta, RenderConfig(width=W, height=H, samples_per_pixel=spp,
                                     engine="mega2")


def step_case(case):
    sid, W, H, spp, K = case
    scene, meta = compile_scene(scenes.build_scene(sid), W, H,
                                dtype=np.float32)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=spp,
                       max_bounces=K)
    pix = np.arange(W * H, dtype=np.int32)
    target = torch.full((W * H, 3), 0.25, dtype=torch.float32)
    return scene, meta, cfg, pix, target


def leaves(params) -> dict:
    return {f"{k}": v.detach().cpu().numpy() for k, v in zip(
        [*train.DIFF_SCENE_FIELDS,
         *(f"camera.{n}" for n in train.CameraParams._fields)],
        train.parameter_list(params))}


def run_steps(mesh=None) -> dict:
    """One taped step (SGD 1e-2) and one mega2 step (Adam 1e-2) from the
    scenes' own parameters, on this rank of ``mesh`` (one device: None)."""
    out = {}
    scene, meta, cfg, pix, target = step_case(TAPED)
    state = train.init_state(scene, lambda ps: torch.optim.SGD(ps, lr=1e-2),
                             device="cpu")
    step = train.make_train_step(scene, meta, cfg, engine="taped", mesh=mesh)
    state, loss = step(state, scene, pix, target)
    out["taped_loss"] = float(loss)
    out.update({f"taped/{k}": v for k, v in leaves(state.params).items()})
    scene, meta, cfg, pix, target = step_case(MEGA2)
    state = train.init_state(scene, lambda ps: torch.optim.Adam(ps, lr=1e-2),
                             device="cpu")
    step = train.make_train_step_mega2(scene, meta, cfg, mesh=mesh)
    state, loss = step(state, pix, target)
    out["mega2_loss"] = float(loss)
    out.update({f"mega2/{k}": v for k, v in leaves(state.params).items()})
    return out


def rank_main(out_dir: str, world: int, rank: int, n_sp: int,
              init: str) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist

    assert distributed.initialize(init_method=init, world_size=world,
                                  rank=rank, backend="gloo", device="cpu")
    assert distributed.initialize()             # idempotent
    assert distributed.is_primary() == (rank == 0)
    mesh = prender.make_mesh(sample_shards=n_sp, device="cpu")
    assert mesh.coord == divmod(rank, n_sp)
    scene, meta, cfg = frame_case()
    res = {"frame": prender.render_sharded(scene, meta, cfg, mesh,
                                           device="cpu"),
           **run_steps(mesh)}
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    dist.destroy_process_group()


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT, HERE] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                        if p])
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
              "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        env.pop(k, None)
    return env


def _wait(procs, what: str) -> list:
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"{what} timed out")
    for p, o in zip(procs, outs):
        assert p.returncode == 0, f"{what} failed:\n{o}"
    return outs


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each shape's world, launched once: {shape: [rank results]}."""
    runs = {}

    def get(shape):
        if shape not in runs:
            n_px, n_sp = shape
            world = n_px * n_sp
            out = tmp_path_factory.mktemp(f"world{n_px}x{n_sp}")
            init = f"tcp://127.0.0.1:{_free_port()}"
            procs = [subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), str(out),
                 str(world), str(r), str(n_sp), init], env=_env(),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for r in range(world)]
            _wait(procs, f"the {n_px}x{n_sp} world")
            runs[shape] = [dict(np.load(out / f"rank{r}.npz"))
                           for r in range(world)]
        return runs[shape]

    return get


@pytest.fixture(scope="module")
def one_device():
    scene, meta, cfg = frame_case()
    return {"frame": np.asarray(render(scene, meta, cfg, device="cpu")),
            **run_steps(None)}


def combine(shape) -> np.ndarray:
    """tests/test_torch_parallel.py's in-process combine of every shard."""
    scene, meta, cfg = frame_case()
    rows = [sum(prender.shard_sums(scene, meta, cfg, shape, (i, j),
                                   device="cpu")
                for j in range(shape[1])) for i in range(shape[0])]
    return prender.finish_frame(
        prender.frame_sums(cfg, shape, torch.stack(rows)), cfg)


@pytest.mark.parametrize("shape", SHAPES)
def test_frame_is_the_in_process_combine(shape, worlds, one_device):
    ranks = worlds(shape)
    want = combine(shape)
    for res in ranks:
        np.testing.assert_array_equal(res["frame"], want)
    if shape[1] == 1:
        np.testing.assert_array_equal(ranks[0]["frame"], one_device["frame"])
    else:
        np.testing.assert_allclose(ranks[0]["frame"], one_device["frame"],
                                   atol=5e-7, rtol=5e-7)


@pytest.mark.parametrize("shape", SHAPES)
def test_ranks_hold_equal_leaves(shape, worlds):
    ranks = worlds(shape)
    for res in ranks[1:]:
        for k, v in ranks[0].items():
            if k != "frame":
                np.testing.assert_array_equal(res[k], v, err_msg=k)


@pytest.mark.parametrize("shape", SHAPES)
def test_taped_mesh_step_matches_one_device(shape, worlds, one_device):
    """JAX's marble bounds (tests/test_parallel.py): loss rel 1e-6, each
    leaf's update within 1e-3 of the one-device update's largest plus
    1e-7; the sphere centers move (geometry gradients are non-zero)."""
    got = worlds(shape)[0]
    np.testing.assert_allclose(got["taped_loss"], one_device["taped_loss"],
                               rtol=1e-6)
    scene = step_case(TAPED)[0]
    init = leaves(train.split_params(scene, "cpu"))
    for k, v0 in init.items():
        d_mesh = got[f"taped/{k}"] - v0
        d_one = one_device[f"taped/{k}"] - v0
        tol = 1e-3 * np.abs(d_one).max() + 1e-7
        assert np.abs(d_mesh - d_one).max() <= tol, k
    assert np.abs(got["taped/sph_c0"] - init["sph_c0"]).max() > 1e-7


@pytest.mark.parametrize("shape", SHAPES)
def test_mega2_mesh_step_matches_one_device(shape, worlds, one_device):
    """JAX's bounds for the mega2 mesh step: loss rel 1e-6, leaves after
    one Adam step within 3e-6."""
    got = worlds(shape)[0]
    np.testing.assert_allclose(got["mega2_loss"], one_device["mega2_loss"],
                               rtol=1e-6)
    for k, v in one_device.items():
        if k.startswith("mega2/"):
            assert np.abs(got[k] - v).max() < 3e-6, k


def test_mega2_mesh_step_matches_jax_mesh_step(worlds):
    """The port's (2, 2) world against JAX's ``make_train_step_mega2(mesh=)``
    on 4 of the suite's virtual devices, the same shape: loss rel 1e-6,
    leaves 3e-6."""
    import jax
    import optax

    from raytracinginoneweekendincuda_tpu.models import scenes as jscenes
    from raytracinginoneweekendincuda_tpu.parallel import train as jtrain
    from raytracinginoneweekendincuda_tpu.parallel.render import make_mesh
    from raytracinginoneweekendincuda_tpu.scene.compiler import (
        compile_scene as jcompile,
    )
    from raytracinginoneweekendincuda_tpu.utils.config import (
        RenderConfig as JConfig,
    )

    sid, W, H, spp, K = MEGA2
    scene, meta = jcompile(jscenes.build_scene(sid), W, H, dtype=np.float32)
    opt = optax.adam(1e-2)
    step = jtrain.make_train_step_mega2(
        scene, meta, JConfig(width=W, height=H, samples_per_pixel=spp,
                             max_bounces=K), opt,
        mesh=make_mesh(jax.devices()[:4], sample_shards=2))
    state, loss = step(jtrain.init_state(scene, opt),
                       np.arange(W * H, dtype=np.int32),
                       np.full((W * H, 3), 0.25, np.float32))
    got = worlds((2, 2))[0]
    np.testing.assert_allclose(got["mega2_loss"], float(loss), rtol=1e-6)
    for f in train.DIFF_SCENE_FIELDS:
        assert np.abs(got[f"mega2/{f}"]
                      - np.asarray(state.params[f])).max() < 3e-6, f
    for n, v in zip(train.CameraParams._fields, state.params["camera"]):
        assert np.abs(got[f"mega2/camera.{n}"] - np.asarray(v)).max() \
            < 3e-6, n


def test_cli_sharded_under_torchrun_writes_the_one_device_ppm(tmp_path):
    """``torch.distributed.run`` with two gloo ranks on the CPU: the PPM
    the primary writes is byte-equal to the one-device CLI's."""
    from raytracinginoneweekendincuda_torch.utils import cli

    args = ["--scene", "4", "--width", "16", "--height", "8", "--spp", "2",
            "--device", "cpu"]
    assert cli.main([*args, "--out", str(tmp_path / "one.ppm")]) == 0
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         "2", "--master_addr", "127.0.0.1", "--master_port", str(port),
         "-m", "raytracinginoneweekendincuda_torch.utils.cli", "--sharded",
         *args, "--out", str(tmp_path / "two.ppm")], env=_env(), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = _wait([proc], "torchrun")[0]
    assert "sharded: Mesh(px=1, sp=2" in out
    assert (tmp_path / "two.ppm").read_bytes() == \
        (tmp_path / "one.ppm").read_bytes()


def test_initialize_without_an_environment_is_one_process(monkeypatch):
    """No launcher environment and no arguments: False, no process group,
    the 1x1 mesh and the primary process; NCCL cannot put two ranks on
    one device."""
    for k in ("MASTER_ADDR", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize() is False
    assert distributed.is_primary()
    assert prender.make_mesh(device="cpu").dims == (1, 1)
    assert distributed.rank_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert distributed.rank_device("cuda") == torch.device("cuda", 3)
    assert distributed.rank_device("cuda:0") == torch.device("cuda", 0)
    with pytest.raises(ValueError, match="one rank on one device"):
        distributed.initialize(init_method="tcp://127.0.0.1:1",
                               world_size=2, rank=1, backend="nccl",
                               device="cuda")


if __name__ == "__main__":
    rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
              int(sys.argv[4]), sys.argv[5])
