"""PyTorch port: the probe tools P1-P3
(``raytracinginoneweekendincuda_torch/tools/probe_*.py``) against the JAX
package's probes (``tools/probe_*.py``), the JAX side run in TPU interpret
mode on the CPU, the port's side through its plain PyTorch versions.

Tolerances:
- P1 (``probe_pair``) at C=32, REP=2, SUB=8: within rtol 1e-4 and atol
  2e-5 (measured: 2.3e-5 at most, on ``k8dot``), NaN and BIG in the same
  places.  The port sums each 16-term coefficient dot left to right and
  rounds every product (``--fmad=false`` on the card), where XLA's CPU dot
  sums in its own order and contracts the interpret-mode kernel's products
  into FMAs; the quadratic's cancellation carries that into the keys.
- P2 (``probe_intmul``) at ITERS=20: the integer flavours bit-exact, also
  against a numpy uint32 reference; ``f32mul`` within rtol 2e-6 (its 160
  roundings, which XLA contracts into FMAs; measured 6e-7).
- P3 (``probe_mosaic``), on the tool's inputs: the loop, the gathers and
  the dots (of ones) exact; trig within 2 ulp of f32 (XLA's acos / atan2
  against PyTorch's).  On each kernel's seeded random inputs (the JAX
  kernel bodies run on them): the loop and the gathers exact; the dots
  within 2 n eps sum|a||b| of an n-term sum (XLA sums in its own order;
  measured 1.75 eps sum|a||b|, the one-hot dot exact); trig within 2 ulp
  (measured 2.0).
"""

import ast
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from raytracinginoneweekendincuda_torch.tools import probe_intmul as ti
from raytracinginoneweekendincuda_torch.tools import probe_mosaic as tm
from raytracinginoneweekendincuda_torch.tools import probe_pair as tp
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIR = (32, 2, 8)        # C, REP, SUB (the wide8_* variants need SUB = 8)
PAIR_RTOL, PAIR_ATOL = 1e-4, 2e-5
INTMUL_ITERS = 20
F32MUL_RTOL = 2e-6
TRIG_ULP = 2
DOTS = ("dynamic_sublane_slice_dot", "f32_matmul", "transposed_onehot_dot")
INT_FLAVOURS = ("i32mul", "u32mul", "u32addxor", "u32mix")


def _tool_path(name: str) -> str:
    return os.path.join(REPO, "tools", name + ".py")


def _import_tool(name: str, argv=()):
    """The JAX tool ``tools/<name>.py`` as a module, with ``sys.argv`` set
    to ``argv`` while it is imported (probe_pair reads it then)."""
    saved = sys.argv
    sys.argv = [_tool_path(name), *argv]
    try:
        spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                      _tool_path(name))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.argv = saved
    return mod


@pytest.fixture(scope="module")
def jax_pair():
    """(JAX tool module, {variant: [SUB, 128] output}, coef, ray) at PAIR."""
    mod = _import_tool("probe_pair", [str(x) for x in PAIR])
    outs = {}
    with pltpu.force_tpu_interpret_mode():
        for v in mod.VARIANTS:
            fn, coef, ray = mod.make_probe(v)
            outs[v] = np.asarray(fn(coef, ray))
    return mod, outs, np.asarray(coef), np.asarray(ray)


@pytest.fixture(scope="module")
def jax_intmul():
    """{flavour: [8, 128] f32 output} of the JAX probe's kernels at
    INTMUL_ITERS.  The tool runs its 5 M-iteration loops when imported, so
    only its imports and definitions are taken from its source."""
    with open(_tool_path("probe_intmul")) as f:
        tree = ast.parse(f.read())
    tree.body = [n for n in tree.body if isinstance(
        n, (ast.Import, ast.ImportFrom, ast.FunctionDef))]
    ns = {"__name__": "jax_probe_intmul"}
    exec(compile(tree, _tool_path("probe_intmul"), "exec"), ns)
    ns["ITERS"] = INTMUL_ITERS
    x = jnp.arange(8 * 128, dtype=jnp.float32).reshape(8, 128) + 1.5
    with pltpu.force_tpu_interpret_mode():
        return {fl: np.asarray(pl.pallas_call(
            ns["make"](fl),
            out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32))(x))
            for fl in ti.FLAVOURS}


@pytest.fixture(scope="module")
def jax_mosaic():
    return _import_tool("probe_mosaic")


# ---- P1 --------------------------------------------------------------------

def test_pair_variants_and_inputs_match_jax(jax_pair):
    mod, _, coef, ray = jax_pair
    assert tp.VARIANTS == mod.VARIANTS
    assert set(tp.KERNEL_OF) == set(mod.VARIANTS)
    c, r = tp.make_inputs(PAIR[0], PAIR[2], "cpu")
    np.testing.assert_array_equal(c.numpy(), coef)
    np.testing.assert_array_equal(r.numpy(), ray)


@pytest.mark.parametrize("variant", tp.VARIANTS)
def test_pair_variant_matches_jax(variant, jax_pair):
    _, outs, coef, ray = jax_pair
    got = tp.probe_pair(torch.tensor(coef), torch.tensor(ray),
                        variant, PAIR[1]).numpy()
    want = outs[variant]
    assert got.shape == want.shape == (PAIR[2], 128)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got >= 1e29, want >= 1e29)
    np.testing.assert_allclose(got, want, rtol=PAIR_RTOL, atol=PAIR_ATOL,
                               equal_nan=True)


# ---- P2 --------------------------------------------------------------------

def _uint32_chain(flavour: str, iters: int) -> np.ndarray:
    x = (np.arange(8 * 128, dtype=np.float32) + np.float32(1.5)).reshape(
        8, 128).view(np.uint32)
    add = np.uint32(ti.ADD[flavour])
    m = np.uint32(ti.MUL)
    with np.errstate(over="ignore"):
        for _ in range(iters):
            for _ in range(8 if flavour != "u32mix" else 4):
                if flavour == "u32addxor":
                    x = (x + add) ^ (x >> np.uint32(16))
                else:
                    x = x * m + add
                    if flavour == "u32mix":
                        x = x ^ (x >> np.uint32(16))
    return x


@pytest.mark.parametrize("flavour", ti.FLAVOURS)
def test_intmul_matches_jax(flavour, jax_intmul):
    got = ti.intmul_chain(ti.make_input("cpu"), flavour,
                          INTMUL_ITERS).numpy()
    want = jax_intmul[flavour]
    if flavour == "f32mul":
        np.testing.assert_allclose(got, want, rtol=F32MUL_RTOL, atol=0)
    else:
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


@pytest.mark.parametrize("flavour", INT_FLAVOURS)
def test_intmul_matches_numpy_uint32(flavour):
    got = ti.intmul_chain(ti.make_input("cpu"), flavour, 7).numpy()
    np.testing.assert_array_equal(got.view(np.uint32),
                                  _uint32_chain(flavour, 7))


# ---- P3 --------------------------------------------------------------------

PROBES = [("probe_while_vector_cond", ()), ("probe_gather_lane", ()),
          ("probe_gather_lane_full", ()), ("probe_gather_sublane", ()),
          ("probe_dynamic_sublane_slice_dot", ()), ("probe_f32_matmul", ()),
          ("probe_transposed_onehot_dot", ()), ("probe_gather_wide", (256,)),
          ("probe_gather_wide", (65536,)), ("probe_gather_wide", (256, 24)),
          ("probe_gather_int32_wide", (524288,)),
          ("probe_gather_timing", ()), ("probe_trig", ())]


@pytest.mark.parametrize("name,args", PROBES,
                         ids=[f"{n}{a}" for n, a in PROBES])
def test_mosaic_probe_matches_jax(name, args, jax_mosaic):
    """Each probe of the JAX tool against the port's function of the same
    name (and arguments)."""
    jfn, tfn = getattr(jax_mosaic, name), getattr(tm, name)
    if args:                       # the closures of the wide gathers
        jfn, tfn = jfn(*args), tfn(*args)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jfn())
    got = tfn("cpu").numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if name == "probe_trig":
        ulp = np.spacing(np.abs(want).astype(np.float32))
        assert (np.abs(got - want) <= TRIG_ULP * ulp).all()
    else:
        np.testing.assert_array_equal(got, want)


def _jax_kernel(probe: str):
    """The kernel body of the JAX tool's ``probe`` function, with the
    constants the function defines (gather_timing's REP), taken from the
    tool's source so that it runs on other inputs than the tool's."""
    path = _tool_path("probe_mosaic")
    with open(path) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == probe)
    body = [n for n in fn.body
            if (isinstance(n, ast.FunctionDef) and n.name == "kernel")
            or (isinstance(n, ast.Assign) and isinstance(n.value, ast.Constant))]
    ns = {"jax": jax, "jnp": jnp, "pl": pl, "pltpu": pltpu}
    exec(compile(ast.Module(body=body, type_ignores=[]), path, "exec"), ns)
    return ns["kernel"]


def _dot_terms_and_magnitude(name, args):
    """(n, sum |a||b|) of a dot case: the terms each output sums and their
    magnitudes, through the plain version on |a| and |b|."""
    if name == "transposed_onehot_dot":
        w, a, hot = args
        return w.shape[0], tm.onehot_dot_plain(w, a.abs(), hot)
    a, b, chunks = args
    return a.shape[1] * chunks, tm.dot_chunks_plain(a.abs(), b.abs(), chunks)


@pytest.mark.parametrize("name", list(tm.CASES))
def test_mosaic_kernel_matches_jax_on_random_inputs(name):
    """Each P3 kernel's plain version against the JAX probe's kernel body
    on the case's seeded random inputs, where the tool's own (ones,
    constants) cannot tell a swapped or misindexed kernel from a right
    one."""
    case = tm.CASES[name]
    args = case.random("cpu")
    got = case.plain(*args).numpy()
    tensors = [a.numpy() for a in args if torch.is_tensor(a)]
    spec = pl.BlockSpec(memory_space=pltpu.VMEM)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pl.pallas_call(
            _jax_kernel("probe_" + name.split("(")[0]),
            out_shape=jax.ShapeDtypeStruct(got.shape, got.dtype),
            in_specs=[spec] * len(tensors), out_specs=spec)(*tensors))
    assert got.shape == want.shape and got.dtype == want.dtype
    if name == "trig":
        ulp = np.spacing(np.abs(want).astype(np.float32))
        assert (np.abs(got - want) <= TRIG_ULP * ulp).all()
    elif name in DOTS:
        n, mag = _dot_terms_and_magnitude(name, args)
        tol = 2 * n * np.finfo(np.float32).eps * mag.numpy()
        assert (np.abs(got - want) <= tol).all()
    else:
        np.testing.assert_array_equal(got, want)


def test_mosaic_cases_cover_the_probes():
    """Every probe function of the JAX tool has its port of the same name;
    the cases (which chip_smoke.py and the card tests walk) run every P3
    kernel; each case's random inputs have the shapes and types of the
    tool's and are not uniform."""
    with open(_tool_path("probe_mosaic")) as f:
        tree = ast.parse(f.read())
    probes = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name.startswith("probe_")}
    assert len(probes) == 11
    assert all(callable(getattr(tm, p, None)) for p in probes)
    assert {"probe_" + n.split("(")[0] for n in tm.CASES} == probes
    assert {c.cuda for c in tm.CASES.values()} == set(tm.WRAPPERS)
    for name, case in tm.CASES.items():
        tool, rand = case.inputs("cpu"), case.random("cpu")
        assert len(tool) == len(rand)
        for t, r in zip(tool, rand):
            if torch.is_tensor(t):
                assert (t.shape, t.dtype) == (r.shape, r.dtype), name
                assert r.unique().numel() > 1, name
            else:
                assert t == r, name
    w = tm.CASES["transposed_onehot_dot"].random("cpu")[0]
    assert 0 < (w == tm.HOT).float().mean() < 1


# ---- the entry points, dispatch ------------------------------------------

def test_probe_pair_main_on_cpu(capsys):
    res = tp.main(["16", "2", "8", "full,noselect,wide8_tree",
                   "--device", "cpu"])
    assert list(res) == ["full", "noselect", "wide8_tree"]
    assert all(r["ms"] > 0 and np.isfinite(r["ns_pair"])
               for r in res.values())
    out = capsys.readouterr().out
    assert "attribution vs full" in out and "cpu" in out


def test_probe_intmul_main_on_cpu(capsys):
    res = ti.main(["--iters", "3", "--device", "cpu"])
    assert list(res) == list(ti.FLAVOURS)
    assert "ratio to f32mul" in capsys.readouterr().out


def test_probe_mosaic_main_on_cpu(capsys):
    outs = tm.main(["-v", "--device", "cpu"])
    assert len(outs) == len(tm.MAIN_PROBES) == 12
    text = capsys.readouterr().out
    assert text.count("OK   ") == 12 and "us/gather" in text


def test_probe_wrappers_dispatch_by_device():
    """CPU tensors take the plain versions and launch nothing; the CUDA
    wrappers refuse CPU tensors; another device raises."""
    wrappers = (tp.probe_pair_cuda, ti.intmul_chain_cuda, *tm.WRAPPERS)
    before = [w.launches for w in wrappers]
    coef, ray = tp.make_inputs(4, 1, "cpu")
    assert tp.probe_pair(coef, ray, "full", 1).shape == (1, 128)
    x = ti.make_input("cpu")
    assert ti.intmul_chain(x, "u32mix", 1).shape == (8, 128)
    tm.probe_trig("cpu")
    assert [w.launches for w in wrappers] == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        tp.probe_pair_cuda(coef, ray, "full", 1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ti.intmul_chain_cuda(x, "f32mul", 1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tm.gather_rows_cuda(*tm.CASES["gather_lane_full"].inputs("cpu"))
    with pytest.raises(ValueError, match="no intmul_chain"):
        ti.intmul_chain(torch.zeros(4, device="meta"), "f32mul", 1)
    with pytest.raises(ValueError, match="no trig"):
        tm.CASES["trig"].dispatch(torch.zeros(4, device="meta"))
    assert [w.launches for w in wrappers] == before
