"""PyTorch port: ``tools/build_ab``'s code comparison on the CPU, on short
PTX and SASS listings in the layout nvcc and cuobjdump print; its output
check, and the output hashes of ``tools/kernel_times``."""

import pytest
import torch

from raytracinginoneweekendincuda_torch.tools import build_ab, kernel_times
from torch_threads import one_torch_thread  # noqa: F401

ANON = "_ZN48_GLOBAL__N__{h}_15_mega2_render_cu_01e0c44e19"
OLD = ANON + "mega2_render_kernelILb1EEEvN5mega26ParamsEPKiiPfPj"
NEW = ANON + "mega2_render_kernelILb1ELb{c}EEEvN5mega26ParamsEPKiiPfPj"


def _ptx(name: str, body: list) -> str:
    lines = "\n".join(f"\t{ln}" for ln in body)
    return (f".visible .entry {name}(\n\t.param .u64 {name}_param_0\n)\n{{\n"
            f"{lines}\n}}\n")


def _sass(name: str, body: list) -> str:
    lines = "\n".join(f"        /*{16 * i:04x}*/                   {ln} ;"
                      f"   /* 0x000000000000000000 */"
                      for i, ln in enumerate(body))
    return (f"\t\tFunction : {name}\n\t.headerflags @\"EF_CUDA_SM90\"\n"
            f"{lines}\n")


def test_kernel_names_and_template_arguments():
    assert build_ab._key(OLD.format(h="7c573552")) == (
        "mega2_render_kernel", ("1",))
    assert build_ab._key(NEW.format(h="bb8f7670", c=0)) == (
        "mega2_render_kernel", ("1", "0"))
    assert build_ab._key(
        "_ZN48_GLOBAL__N__7c573552_14_mega2_trace_cu_f025b89118"
        "mega2_trace_kernelEN5mega26ParamsEPKiS3_PKfiPi") == (
        "mega2_trace_kernel", ())


@pytest.mark.parametrize("mangled,want", [
    ("_ZN48_GLOBAL__N__7c573552_16_mega_bounces_cu_2b4e9d1a19"
     "mega_bounces_kernelEN12_GLOBAL__N_110MegaParamsEPKfPKiiPfPi",
     ("mega_bounces_kernel", ())),
    ("_ZN48_GLOBAL__N__7c573552_15_closest_geo_cu_6f1a2c3d18"
     "closest_geo_kernelEPKfiS1_iS1_ifPfPi", ("closest_geo_kernel", ())),
    ("_ZN48_GLOBAL__N__bb8f7670_15_closest_geo_cu_6f1a2c3d18"
     "closest_geo_kernelILb1EEEvPKfiS2_iS2_ifPfPi",
     ("closest_geo_kernel", ("1",))),
], ids=["K5", "K6 before", "K6 staged"])
def test_kernel_names_of_k5_and_k6(mangled, want):
    """The file name in the anonymous namespace's mangling is not taken
    for the kernel's name."""
    assert build_ab._key(mangled) == want


@pytest.mark.parametrize("mangled,want", [
    ("_ZN48_GLOBAL__N__7c573552_13_replay_fwd_cu_3a9e1b2c17"
     "replay_fwd_kernelEN6replay6ParamsEPKfPKiS5_Pf",
     ("replay_fwd_kernel", ())),
    ("_ZN48_GLOBAL__N__7c573552_13_replay_bwd_cu_3a9e1b2c17"
     "replay_bwd_kernelEN6replay6ParamsEPKfPKiS5_S3_PfS6_S6_",
     ("replay_bwd_kernel", ())),
    ("_ZN48_GLOBAL__N__bb8f7670_13_replay_bwd_cu_3a9e1b2c17"
     "replay_bwd_kernelILb1EEEvN6replay6ParamsEPKfPKiS6_S4_PfS7_S7_Pj",
     ("replay_bwd_kernel", ("1",))),
    ("_ZN48_GLOBAL__N__7c573552_15_probe_mosaic_cu_5d2e7a1c21"
     "gather_sublane_kernelEPKfiiPKiPf", ("gather_sublane_kernel", ())),
    ("_ZN48_GLOBAL__N__7c573552_15_probe_mosaic_cu_5d2e7a1c18"
     "gather_rows_kernelILb0EEvPKjiPKiiPj", ("gather_rows_kernel", ("0",))),
    ("_ZN48_GLOBAL__N__7c573552_15_probe_mosaic_cu_5d2e7a1c17"
     "onehot_dot_kernelEPKiPKfiiiiPf", ("onehot_dot_kernel", ())),
    ("_ZN48_GLOBAL__N__7c573552_15_probe_mosaic_cu_5d2e7a1c11"
     "trig_kernelEPKfiPf", ("trig_kernel", ())),
], ids=["K3", "K4 before", "K4 shared", "P3 gather_sublane",
        "P3 gather_rows", "P3 onehot_dot", "P3 trig"])
def test_kernel_names_of_k3_k4_and_p3(mangled, want):
    """K3, K4 and the eight P3 kernels of probe_mosaic.cu, whose names are
    not the source's, are found by their own names."""
    assert build_ab._key(mangled) == want


def test_same_outputs_flags_a_differing_hash():
    runs = [{"checkout": 0, "k6_ms": 0.2, "k6_sha256": "a", "k2_sha256": "b"},
            {"checkout": 1, "k6_ms": 0.1, "k6_sha256": "a", "k2_sha256": "c"},
            {"checkout": 1, "k6_sha256": "a"},
            {"checkout": 0, "k6_ms": 0.2, "k6_sha256": "a", "k2_sha256": "b"}]
    assert build_ab.same_outputs(runs) == {"k6_sha256": True,
                                          "k2_sha256": False}
    assert build_ab.same_outputs(runs[:1] + runs[2:]) == {
        "k6_sha256": True, "k2_sha256": True}


def test_digest_is_of_the_outputs_bytes_in_order():
    """kernel_times' hash: equal tensors give one hash wherever they lie
    and however they are strided; a flipped bit, or the order of two
    outputs, changes it."""
    t = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    p = torch.tensor([-1, 0, 7], dtype=torch.int32)
    h = kernel_times.digest(t, p)
    assert h == kernel_times.digest(t.T.contiguous().T, p.clone())
    assert len(h) == 64
    assert h != kernel_times.digest(p, t)
    bits = t.clone()
    bits.view(torch.int32)[1, 2] ^= 1
    assert h != kernel_times.digest(bits, p)


def test_compare_matches_the_instantiation_without_the_later_option():
    """The old kernel<1> is matched with the new kernel<1,0>, not
    kernel<1,1>; PTX virtual registers, labels and the anonymous
    namespace's hash, and SASS register numbers, do not count as
    differences; a reordered pair of instructions does."""
    body = ["mov.u32 %r1, %r2;", "ld.shared.f32 %f3, [" + ANON.format(
        h="{h}") + "9smem_rowsE];", "$L__BB0_1:", "add.f32 %f4, %f3, %f3;"]
    old_ptx = _ptx(OLD.format(h="7c573552"),
                   [ln.format(h="7c573552") for ln in body])
    same = [ln.format(h="bb8f7670").replace("%r1", "%r7") for ln in body]
    swapped = [same[0], same[3], same[2], same[1]]
    new_ptx = (_ptx(NEW.format(h="bb8f7670", c=0), same)
               + _ptx(NEW.format(h="bb8f7670", c=1), swapped))
    sass = ["MOV R1, c[0x0][0x28]", "FADD R4, R3, R3", "EXIT"]
    old_sass = _sass(OLD.format(h="7c573552"), sass)
    new_sass = (_sass(NEW.format(h="bb8f7670", c=0),
                      [s.replace("R4", "R9") for s in sass])
                + _sass(NEW.format(h="bb8f7670", c=1), sass[::-1]))
    empty = {k: {"ptx": "", "sass": ""} for k in build_ab.KERNELS}
    base = {**empty, "mega2_render": {"ptx": old_ptx, "sass": old_sass}}
    other = {**empty, "mega2_render": {"ptx": new_ptx, "sass": new_sass}}
    got = build_ab.compare(base, other)
    assert got == {"mega2_render_kernel<1>": {
        "matched": "mega2_render_kernel<1,0>",
        "ptx_stretches": 0, "ptx_lines": [7, 7],
        "sass_stretches": 0, "sass_lines": [3, 3]}}
    other["mega2_render"]["ptx"] = _ptx(NEW.format(h="bb8f7670", c=0),
                                        swapped)
    assert build_ab.compare(base, other)[
        "mega2_render_kernel<1>"]["ptx_stretches"] > 0
