"""``chip_smoke.py``'s report of the flash and paged kernels in the
built library, and the bound its wire arms hold adopted blocks to.

The report comes from ``cuobjdump -res-usage -sass`` of the library
alone, so a library reused from an earlier build reports the same
registers, spills and tensor-core instructions as a fresh one.  These
tests feed it ``cuobjdump`` output in the tool's layout.
"""

import importlib.util
import os
import subprocess

import pytest

_PATH = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                     "chip_smoke.py")
_spec = importlib.util.spec_from_file_location("chip_smoke", _PATH)
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

_NS_TC = "_ZN56_GLOBAL__N__32543659_23_flash_attention_sm90_cu_7f0596a5"
_NS_CC = "_ZN51_GLOBAL__N__2949fed5_18_flash_attention_cu_393d3e2b"
FWD_TC = (_NS_TC + "12flash_fwd_tcILi128EEEvPK13__nv_bfloat16S3_S3_PS1_Pf"
          "N4vtpu5flash7ProblemEib")
# the forward templated on its output: bf16, and f32 (the f32-out entry)
FWD_TC_BF16 = (_NS_TC + "12flash_fwd_tcILi128E13__nv_bfloat16EEvPKS1_S3_S3_"
               "PT0_PfN4vtpu5flash7ProblemEib")
FWD_TC_F32 = {hd: (_NS_TC + f"12flash_fwd_tcILi{hd}EfEEvPK13__nv_bfloat16S3_"
                   "S3_PT0_PfN4vtpu5flash7ProblemEib") for hd in (64, 128)}
DKV_TC = (_NS_TC + "12flash_dkv_tcILi128EEEvPK13__nv_bfloat16S3_S3_S3_PKf"
          "S5_PS1_S6_N4vtpu5flash7ProblemEib")
DQ_TC = (_NS_TC + "11flash_dq_tcILi128EEEvPK13__nv_bfloat16S3_S3_S3_PKfS5_"
         "PS1_N4vtpu5flash7ProblemEib")
DQ_F32 = (_NS_CC + "12flash_bwd_dqIfLi128EEEvPKT_S2_S2_S2_PKfS4_PS0_"
          "N4vtpu5flash7ProblemEb")
# the bf16 wide backward (128 < hd <= 512): split over warps up to hd
# 256, chunked over blocks above
DQ_WIDE = {256: (_NS_TC + "17flash_dq_split_tcILi256EEEvPK13__nv_bfloat16"
                 "S3_S3_S3_PKfS5_PS1_N4vtpu5flash7ProblemEib"),
           512: (_NS_TC + "16flash_dq_wide_tcILi512EEEvPK13__nv_bfloat16"
                 "S3_S3_S3_PKfS5_PS1_N4vtpu5flash7ProblemEiib")}
DKV_WIDE = {256: (_NS_TC + "18flash_dkv_split_tcILi256EEEvPK13__nv_bfloat16"
                  "S3_S3_S3_PKfS5_PS1_S6_N4vtpu5flash7ProblemEiib"),
            512: (_NS_TC + "17flash_dkv_wide_tcILi512EEEvPK13__nv_bfloat16"
                  "S3_S3_S3_PKfS5_PS1_S6_N4vtpu5flash7ProblemEiiib")}
# the wide forward (128 < hd <= 512), bf16 and f32 o: split over warps up
# to hd 256, chunked over blocks above
FWD_WIDE = {(256, "bf16"): (_NS_TC + "18flash_fwd_split_tcILi256E13__nv_"
                            "bfloat16EEvPKS1_S3_S3_PT0_PfN4vtpu5flash7"
                            "ProblemEib"),
            (256, "f32"): (_NS_TC + "18flash_fwd_split_tcILi256EfEEvPK13__"
                           "nv_bfloat16S3_S3_PT0_PfN4vtpu5flash7ProblemEib"),
            (512, "bf16"): (_NS_TC + "17flash_fwd_wide_tcILi512E13__nv_"
                            "bfloat16EEvPKS1_S3_S3_PT0_PfN4vtpu5flash7"
                            "ProblemEiib"),
            (512, "f32"): (_NS_TC + "17flash_fwd_wide_tcILi512EfEEvPK13__"
                           "nv_bfloat16S3_S3_PT0_PfN4vtpu5flash7ProblemEiib")}
# the f32 backward at hd <= 128 as 3xTF32 (TF32 mma.sync)
_NS_T3 = "_ZN58_GLOBAL__N__47a195ba_25_flash_attention_tf32x3_cu_0d4e81e2"
DQ_T3 = {hd: (_NS_T3 + f"15flash_dq_tf32x3ILi{hd}EEEvPKfS2_S2_S2_S2_S2_Pf"
              "N4vtpu5flash7ProblemEib") for hd in (64, 128)}
DKV_T3 = {hd: (_NS_T3 + f"16flash_dkv_tf32x3ILi{hd}EEEvPKfS2_S2_S2_S2_S2_"
               "PfS3_N4vtpu5flash7ProblemEib") for hd in (64, 128)}
# and above hd 128 (the output columns split over a block's warps)
DQ_T3_WIDE = {hd: (_NS_T3 + f"21flash_dq_split_tf32x3ILi{hd}EEEvPKfS2_S2_"
                   "S2_S2_S2_PfN4vtpu5flash7ProblemEib") for hd in (256, 512)}
DKV_T3_WIDE = {hd: (_NS_T3 + f"22flash_dkv_split_tf32x3ILi{hd}EEEvPKfS2_"
                    "S2_S2_S2_S2_PfS3_N4vtpu5flash7ProblemEib")
               for hd in (256, 512)}
# the f32 forward as 3xTF32, one template at every hd
FWD_T3 = {hd: (_NS_T3 + f"16flash_fwd_tf32x3ILi{hd}EEEvPKfS2_S2_PfS3_N4vtpu5"
               "flash7ProblemEib") for hd in (64, 128, 256, 512)}
FWD_F32OUT = (_NS_CC + "9flash_fwdI13__nv_bfloat16fLi64EEEvPKT_S4_S4_PT0_Pf"
              "N4vtpu5flash7ProblemEb")
_NS_PA = "_ZN51_GLOBAL__N__04d40e2e_18_paged_attention_cu_da7c5523"
PARTIAL_BF16 = (_NS_PA + "13paged_partialI13__nv_bfloat16S1_Lb0ELi4ELi4EEEvPKT_"
                "PKT0_S7_PKfS9_PKiSB_PfSC_NS_8GeometryENS_6LayoutEifb")
PARTIAL_Q8 = (_NS_PA + "13paged_partialIfaLb1ELi8ELi2EEEvPKT_PKT0_S5_PKfS7_"
              "PKiS9_PfSA_NS_8GeometryENS_6LayoutEifb")
COMBINE_BF16 = (_NS_PA + "13paged_combineI13__nv_bfloat16EEvPKfS3_PKiPT_"
                "NS_8GeometryE")
LN = "_ZN4vtpu9ln_kernelIfEEvPKT_PKfS5_PS1_iif"


def _dump(dkv_stack=0, dkv_spills=False, fwd_mma=True, paged_stack=0,
          paged_spills=False, f32out_stack=0, f32out_spills=False,
          wide_spills=None, wide_mma=True, wide_fwd_mma=True,
          f32bwd_mma=True, f32wide_mma=True, f32fwd_mma=True) -> str:
    """cuobjdump -res-usage -sass output for twenty-seven flash kernels
    (the f32-out forward at hd 64 and 128, the wide backward's four
    instances, the wide forward's four, the f32 backward's four 3xTF32
    ones at hd <= 128 and its four above, and the f32 forward's four
    among them), three paged kernels and one other kernel.
    ``wide_spills`` names a wide or 3xTF32 instance that spills; without
    ``wide_mma`` the wide backward's instances, without ``wide_fwd_mma``
    the wide forward's, without ``f32bwd_mma`` the 3xTF32 backward's at
    hd <= 128, without ``f32wide_mma`` those above hd 128, without
    ``f32fwd_mma`` the f32 forward's hold no tensor-core instruction."""
    hmma = "HMMA.16816.F32.BF16 R4, R8, R12, R4 ;"
    tf32 = "HMMA.1688.F32.TF32 R4, R8, R12, R4 ;"
    wide = []
    for sym, reg, mma in ((DQ_WIDE[256], 236, wide_mma),
                          (DQ_WIDE[512], 238, wide_mma),
                          (DKV_WIDE[256], 250, wide_mma),
                          (DKV_WIDE[512], 248, wide_mma),
                          *((FWD_WIDE[key], 200 + i, wide_fwd_mma)
                            for i, key in enumerate(FWD_WIDE)),
                          *((sym, 160 + i, f32bwd_mma) for i, sym in
                            enumerate((DQ_T3[64], DQ_T3[128], DKV_T3[64],
                                       DKV_T3[128]))),
                          *((sym, 170 + i, f32wide_mma) for i, sym in
                            enumerate((DQ_T3_WIDE[256], DQ_T3_WIDE[512],
                                       DKV_T3_WIDE[256],
                                       DKV_T3_WIDE[512]))),
                          *((sym, 180 + i, f32fwd_mma) for i, sym in
                            enumerate(FWD_T3.values()))):
        spills = chip_smoke._short(sym) == wide_spills
        op = tf32 if "tf32x3" in sym else hmma
        wide.append((sym, reg, 24 if spills else 0,
                     ([op] * 2 if mma else ["FFMA R1, R2, R3, R1 ;"])
                     + (["STL [R1+0x18], R9 ;"] if spills else [])))
    usage = [" Function {}:".format(LN),
             "  REG:32 STACK:0 SHARED:0 LOCAL:0 CONSTANT[0]:400"]
    sass = []
    for sym, reg, stack, body in (
            (FWD_TC, 240, 0, ["HMMA.16816.F32.BF16 R4, R8, R12, R4 ;"] * 3
             if fwd_mma else ["FFMA R1, R2, R3, R1 ;"]),
            (DKV_TC, 245, dkv_stack,
             ["HMMA.16816.F32.BF16 R4, R8, R12, R4 ;"] * 2
             + (["STL.64 [R1+0x8], R4 ;", "LDL.LU R5, [R1+0x8] ;"]
                if dkv_spills else [])),
            (DQ_TC, 244, 0, ["HMMA.16816.F32.BF16 R4, R8, R12, R4 ;"] * 4),
            (FWD_TC_F32[64], 168, 0,
             ["HMMA.16816.F32.BF16 R4, R8, R12, R4 ;"] * 5),
            (FWD_TC_F32[128], 232, f32out_stack,
             ["HMMA.16816.F32.BF16 R4, R8, R12, R4 ;"] * 6
             + (["STL [R1+0x10], R7 ;"] if f32out_spills else [])),
            (DQ_F32, 168, 0, ["FFMA R1, R2, R3, R1 ;"]),
            (FWD_F32OUT, 128, 0, ["LDS.128 R4, [R2] ;"]),
            (PARTIAL_BF16, 96, 0, ["SHFL.BFLY PT, R4, R5, 0x10, 0x1f ;"]),
            (PARTIAL_Q8, 118, paged_stack,
             ["PRMT R4, R5, 0x7440, R6 ;"]
             + (["STL [R1+0x4], R4 ;"] if paged_spills else [])),
            (COMBINE_BF16, 30, 0, ["MUFU.EX2 R4, R5 ;"]), *wide):
        usage += [" Function {}:".format(sym),
                  "  REG:{} STACK:{} SHARED:0 LOCAL:0 CONSTANT[0]:612 "
                  "TEXTURE:0 SURFACE:0 SAMPLER:0".format(reg, stack)]
        sass += ["\t\tFunction : {}".format(sym),
                 "\t.headerflags\t@\"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)\""]
        sass += ["        /*{:04x}*/  {}".format(16 * i, ins)
                 for i, ins in enumerate(["LDC R1, c[0x0][0x28] ;", *body,
                                          "EXIT ;"])]
    return "\n".join(["", "Fatbin elf code:", "================",
                      "arch = sm_90a", "", "Resource usage:", " Common:",
                      "  GLOBAL:0", *usage, "", "Fatbin elf code:",
                      "================", "arch = sm_90a", "", "\tcode for sm_90a",
                      *sass, ""])


@pytest.mark.parametrize("sym, short", [
    (FWD_TC, "flash_fwd_tc<128>"),
    (DKV_TC, "flash_dkv_tc<128>"),
    (DQ_TC, "flash_dq_tc<128>"),
    (FWD_TC_BF16, "flash_fwd_tc<128,bf16>"),
    (FWD_TC_F32[64], "flash_fwd_tc<64,f32>"),
    (FWD_TC_F32[128], "flash_fwd_tc<128,f32>"),
    (DQ_F32, "flash_bwd_dq<f32,128>"),
    (FWD_F32OUT, "flash_fwd<bf16,f32,64>"),
    (DQ_WIDE[256], "flash_dq_split_tc<256>"),
    (DKV_WIDE[512], "flash_dkv_wide_tc<512>"),
    (FWD_WIDE[256, "bf16"], "flash_fwd_split_tc<256,bf16>"),
    (FWD_WIDE[256, "f32"], "flash_fwd_split_tc<256,f32>"),
    (FWD_WIDE[512, "bf16"], "flash_fwd_wide_tc<512,bf16>"),
    (FWD_WIDE[512, "f32"], "flash_fwd_wide_tc<512,f32>"),
    (DQ_T3[128], "flash_dq_tf32x3<128>"),
    (DKV_T3[64], "flash_dkv_tf32x3<64>"),
    (DQ_T3_WIDE[256], "flash_dq_split_tf32x3<256>"),
    (DKV_T3_WIDE[512], "flash_dkv_split_tf32x3<512>"),
    (FWD_T3[64], "flash_fwd_tf32x3<64>"),
    (FWD_T3[512], "flash_fwd_tf32x3<512>"),
    (PARTIAL_BF16, "paged_partial<bf16,bf16,false,4,4>"),
    (PARTIAL_Q8, "paged_partial<f32,i8,true,8,2>"),
    (COMBINE_BF16, "paged_combine<bf16>"),
    ("not_a_mangled_name", "not_a_mangled_name"),
])
def test_short_names_of_the_mangled_kernels(sym, short):
    assert chip_smoke._short(sym) == short


def test_parse_reads_registers_stack_locals_and_tensor_core_ops():
    report = chip_smoke.parse_cuobjdump(_dump())
    assert report == {
        "flash_fwd_tc<128>": dict(registers=240, stack_bytes=0, local_ops=0,
                                  tensor_core_ops=3),
        "flash_dkv_tc<128>": dict(registers=245, stack_bytes=0, local_ops=0,
                                  tensor_core_ops=2),
        "flash_dq_tc<128>": dict(registers=244, stack_bytes=0, local_ops=0,
                                 tensor_core_ops=4),
        "flash_fwd_tc<64,f32>": dict(registers=168, stack_bytes=0,
                                     local_ops=0, tensor_core_ops=5),
        "flash_fwd_tc<128,f32>": dict(registers=232, stack_bytes=0,
                                      local_ops=0, tensor_core_ops=6),
        "flash_bwd_dq<f32,128>": dict(registers=168, stack_bytes=0,
                                      local_ops=0, tensor_core_ops=0),
        "flash_fwd<bf16,f32,64>": dict(registers=128, stack_bytes=0,
                                       local_ops=0, tensor_core_ops=0),
        "paged_partial<bf16,bf16,false,4,4>": dict(
            registers=96, stack_bytes=0, local_ops=0, tensor_core_ops=0),
        "paged_partial<f32,i8,true,8,2>": dict(
            registers=118, stack_bytes=0, local_ops=0, tensor_core_ops=0),
        "paged_combine<bf16>": dict(registers=30, stack_bytes=0,
                                    local_ops=0, tensor_core_ops=0),
        "flash_dq_split_tc<256>": dict(registers=236, stack_bytes=0,
                                       local_ops=0, tensor_core_ops=2),
        "flash_dq_wide_tc<512>": dict(registers=238, stack_bytes=0,
                                      local_ops=0, tensor_core_ops=2),
        "flash_dkv_split_tc<256>": dict(registers=250, stack_bytes=0,
                                        local_ops=0, tensor_core_ops=2),
        "flash_dkv_wide_tc<512>": dict(registers=248, stack_bytes=0,
                                       local_ops=0, tensor_core_ops=2),
        **{name: dict(registers=200 + i, stack_bytes=0, local_ops=0,
                      tensor_core_ops=2)
           for i, name in enumerate(chip_smoke.WIDE_FWD_INSTANCES)},
        **{name: dict(registers=160 + i, stack_bytes=0, local_ops=0,
                      tensor_core_ops=2)
           for i, name in enumerate(chip_smoke.F32_BWD_INSTANCES)},
        **{name: dict(registers=170 + i, stack_bytes=0, local_ops=0,
                      tensor_core_ops=2)
           for i, name in enumerate(chip_smoke.F32_WIDE_BWD_INSTANCES)},
        **{name: dict(registers=180 + i, stack_bytes=0, local_ops=0,
                      tensor_core_ops=2)
           for i, name in enumerate(chip_smoke.F32_FWD_INSTANCES)},
    }
    assert chip_smoke.build_failures(report) == []


def test_a_spilling_tensor_core_kernel_fails_the_build_check():
    report = chip_smoke.parse_cuobjdump(_dump(dkv_stack=16, dkv_spills=True))
    row = report["flash_dkv_tc<128>"]
    assert row["stack_bytes"] == 16 and row["local_ops"] == 2
    (bad,) = chip_smoke.build_failures(report)
    assert bad.startswith("flash_dkv_tc<128>: spills")


def test_a_kernel_without_tensor_core_ops_or_missing_fails():
    report = chip_smoke.parse_cuobjdump(_dump(fwd_mma=False))
    assert chip_smoke.build_failures(report) == [
        "flash_fwd_tc<128>: no tensor-core instructions in its SASS"]
    del report["flash_dkv_tc<128>"]
    assert "flash_dkv_tc: not in the library" in \
        chip_smoke.build_failures(report)


def test_a_library_without_the_tensor_core_dq_fails():
    """The bf16 dq entry runs flash_dq_tc: a library that lacks it (one
    built from sources that still send bf16 dq to the CUDA cores) fails."""
    report = chip_smoke.parse_cuobjdump(_dump())
    del report["flash_dq_tc<128>"]
    assert chip_smoke.build_failures(report) == [
        "flash_dq_tc: not in the library"]


@pytest.mark.parametrize("name", ["flash_fwd_tc<64,f32>",
                                  "flash_fwd_tc<128,f32>"])
def test_a_library_without_the_f32out_forward_fails(name):
    """The bf16 -> f32-out entry runs flash_fwd_tc with f32 o at hd 64
    and 128: a library that lacks either instance (one built from
    sources that still send that entry to the CUDA cores, whose
    flash_fwd<bf16,f32,...> does not count) fails."""
    report = chip_smoke.parse_cuobjdump(_dump())
    del report[name]
    assert "flash_fwd<bf16,f32,64>" in report
    assert chip_smoke.build_failures(report) == [
        f"{name}: not in the library"]


def test_a_spilling_f32out_forward_fails_the_build_check():
    """The split P V adds a second A fragment a k-step: a build where
    that spills fails, like any tensor-core kernel."""
    report = chip_smoke.parse_cuobjdump(_dump(f32out_stack=8,
                                              f32out_spills=True))
    assert chip_smoke.build_failures(report) == [
        "flash_fwd_tc<128,f32>: spills (stack 8 bytes, 1 local "
        "loads/stores)"]


@pytest.mark.parametrize("name", ["flash_dq_split_tc<256>",
                                  "flash_dq_wide_tc<512>",
                                  "flash_dkv_split_tc<256>",
                                  "flash_dkv_wide_tc<512>"])
def test_a_library_without_a_wide_backward_instance_fails(name):
    """The bf16 wide entries run flash_dq_split_tc and flash_dkv_split_tc
    up to hd 256, flash_dq_wide_tc and flash_dkv_wide_tc above: a library
    that lacks any of them (one built from sources that still send them
    to the CUDA cores, whose flash_bwd_dq_wide does not count) fails."""
    report = chip_smoke.parse_cuobjdump(_dump())
    del report[name]
    assert chip_smoke.build_failures(report) == [
        f"{name}: not in the library",
        f"{name.split('<')[0]}: not in the library"]


@pytest.mark.parametrize("name", ["flash_dq_wide_tc<512>",
                                  "flash_dkv_split_tc<256>"])
def test_a_spilling_wide_backward_fails_the_build_check(name):
    """The wide backward holds 128 columns of dq (or of dk and dv) a warp
    beside S and dP: a build where that spills fails."""
    report = chip_smoke.parse_cuobjdump(_dump(wide_spills=name))
    assert report[name]["stack_bytes"] == 24
    assert chip_smoke.build_failures(report) == [
        f"{name}: spills (stack 24 bytes, 1 local loads/stores)"]


def test_a_wide_backward_without_tensor_core_ops_fails():
    report = chip_smoke.parse_cuobjdump(_dump(wide_mma=False))
    assert chip_smoke.build_failures(report) == [
        f"{name}: no tensor-core instructions in its SASS"
        for name in ("flash_dq_split_tc<256>", "flash_dkv_split_tc<256>",
                     "flash_dq_wide_tc<512>", "flash_dkv_wide_tc<512>")]


@pytest.mark.parametrize("name", ["flash_fwd_split_tc<256,bf16>",
                                  "flash_fwd_split_tc<256,f32>",
                                  "flash_fwd_wide_tc<512,bf16>",
                                  "flash_fwd_wide_tc<512,f32>"])
def test_a_library_without_a_wide_forward_instance_fails(name):
    """The bf16 and f32-out wide entries run flash_fwd_split_tc up to hd
    256 and flash_fwd_wide_tc above: a library that lacks any instance
    (one built from sources that still send them to the CUDA cores, whose
    flash_fwd_wide does not count) fails."""
    report = chip_smoke.parse_cuobjdump(_dump())
    del report[name]
    assert chip_smoke.build_failures(report) == [
        f"{name}: not in the library"]
    for other in chip_smoke.WIDE_FWD_INSTANCES:
        if other.split("<")[0] == name.split("<")[0]:
            report.pop(other, None)
    assert f"{name.split('<')[0]}: not in the library" in \
        chip_smoke.build_failures(report)


@pytest.mark.parametrize("name", ["flash_fwd_split_tc<256,f32>",
                                  "flash_fwd_wide_tc<512,bf16>"])
def test_a_spilling_wide_forward_fails_the_build_check(name):
    """The wide forward holds 128 columns of o a warp beside S (and Q's
    fragments up to hd 256): a build where that spills fails."""
    report = chip_smoke.parse_cuobjdump(_dump(wide_spills=name))
    assert report[name]["stack_bytes"] == 24
    assert chip_smoke.build_failures(report) == [
        f"{name}: spills (stack 24 bytes, 1 local loads/stores)"]


def test_a_wide_forward_without_tensor_core_ops_fails():
    report = chip_smoke.parse_cuobjdump(_dump(wide_fwd_mma=False))
    assert chip_smoke.build_failures(report) == [
        f"{name}: no tensor-core instructions in its SASS"
        for name in chip_smoke.WIDE_FWD_INSTANCES]


@pytest.mark.parametrize("name", ["flash_dq_tf32x3<64>",
                                  "flash_dq_tf32x3<128>",
                                  "flash_dkv_tf32x3<64>",
                                  "flash_dkv_tf32x3<128>"])
def test_a_library_without_an_f32_backward_instance_fails(name):
    """The f32 dq and dk/dv entries run flash_dq_tf32x3 and
    flash_dkv_tf32x3 at hd 64 and 128: a library that lacks any instance
    (one built from sources that still send the f32 backward to the CUDA
    cores, whose flash_bwd_dq<f32,128> does not count) fails, and one
    that lacks both of a kernel's instances fails for the kernel too."""
    report = chip_smoke.parse_cuobjdump(_dump())
    del report[name]
    assert "flash_bwd_dq<f32,128>" in report
    assert chip_smoke.build_failures(report) == [
        f"{name}: not in the library"]
    kernel = name.split("<")[0]
    for other in chip_smoke.F32_BWD_INSTANCES:
        if other.split("<")[0] == kernel:
            report.pop(other, None)
    assert f"{kernel}: not in the library" in \
        chip_smoke.build_failures(report)


@pytest.mark.parametrize("name", ["flash_dq_tf32x3<128>",
                                  "flash_dkv_tf32x3<128>"])
def test_a_spilling_f32_backward_fails_the_build_check(name):
    """dq holds hd / 2 f32 a thread beside S and dP, and a dk/dv warp its
    output beside S^T or dP^T: a build where that spills fails."""
    report = chip_smoke.parse_cuobjdump(_dump(wide_spills=name))
    assert report[name]["stack_bytes"] == 24
    assert chip_smoke.build_failures(report) == [
        f"{name}: spills (stack 24 bytes, 1 local loads/stores)"]


def test_an_f32_backward_without_tensor_core_ops_fails():
    """A build whose f32 backward multiplies on the CUDA cores (no TF32
    HMMA in its SASS) fails for every instance."""
    report = chip_smoke.parse_cuobjdump(_dump(f32bwd_mma=False))
    assert chip_smoke.build_failures(report) == [
        f"{name}: no tensor-core instructions in its SASS"
        for name in ("flash_dq_tf32x3<64>", "flash_dq_tf32x3<128>",
                     "flash_dkv_tf32x3<64>", "flash_dkv_tf32x3<128>")]


@pytest.mark.parametrize("name", ["flash_dq_split_tf32x3<256>",
                                  "flash_dq_split_tf32x3<512>",
                                  "flash_dkv_split_tf32x3<256>",
                                  "flash_dkv_split_tf32x3<512>"])
def test_a_library_without_a_wide_f32_backward_instance_fails(name):
    """The wide f32 dq and dk/dv entries run flash_dq_split_tf32x3 and
    flash_dkv_split_tf32x3 at <256> (hd <= 256) and <512>: a library that
    lacks any instance (one built from sources that still send them to
    the CUDA cores) fails, and one that lacks both of a kernel's
    instances fails for the kernel too."""
    report = chip_smoke.parse_cuobjdump(_dump())
    del report[name]
    assert chip_smoke.build_failures(report) == [
        f"{name}: not in the library"]
    kernel = name.split("<")[0]
    for other in chip_smoke.F32_WIDE_BWD_INSTANCES:
        if other.split("<")[0] == kernel:
            report.pop(other, None)
    assert f"{kernel}: not in the library" in \
        chip_smoke.build_failures(report)


@pytest.mark.parametrize("name", ["flash_dq_split_tf32x3<256>",
                                  "flash_dq_split_tf32x3<512>",
                                  "flash_dkv_split_tf32x3<256>",
                                  "flash_dkv_split_tf32x3<512>"])
def test_a_spilling_wide_f32_backward_fails_the_build_check(name):
    """A warp holds 128 columns of dq, dk or dv beside its shares of S and
    dP (and dq the next K/V tile): a build where that spills fails."""
    report = chip_smoke.parse_cuobjdump(_dump(wide_spills=name))
    assert report[name]["stack_bytes"] == 24
    assert chip_smoke.build_failures(report) == [
        f"{name}: spills (stack 24 bytes, 1 local loads/stores)"]


def test_a_wide_f32_backward_without_tf32_mma_fails():
    """A build whose wide f32 backward multiplies on the CUDA cores (no
    TF32 HMMA in its SASS) fails for every instance, and the kernels at
    hd <= 128 are not taken for them."""
    report = chip_smoke.parse_cuobjdump(_dump(f32wide_mma=False))
    assert report["flash_dq_tf32x3<128>"]["tensor_core_ops"] == 2
    assert chip_smoke.build_failures(report) == [
        f"{name}: no tensor-core instructions in its SASS"
        for name in ("flash_dq_split_tf32x3<256>",
                     "flash_dq_split_tf32x3<512>",
                     "flash_dkv_split_tf32x3<256>",
                     "flash_dkv_split_tf32x3<512>")]


@pytest.mark.parametrize("name", ["flash_fwd_tf32x3<64>",
                                  "flash_fwd_tf32x3<128>",
                                  "flash_fwd_tf32x3<256>",
                                  "flash_fwd_tf32x3<512>"])
def test_a_library_without_an_f32_forward_instance_fails(name):
    """The f32 forward entries run flash_fwd_tf32x3 at <64> and <128>
    (hd <= 128) and at <256> and <512> (above): a library that lacks any
    instance (one built from sources that still send the f32 forward to
    the CUDA cores) fails, and one that lacks all four fails for the
    kernel too."""
    report = chip_smoke.parse_cuobjdump(_dump())
    del report[name]
    assert chip_smoke.build_failures(report) == [
        f"{name}: not in the library"]
    for other in chip_smoke.F32_FWD_INSTANCES:
        report.pop(other, None)
    assert "flash_fwd_tf32x3: not in the library" in \
        chip_smoke.build_failures(report)


@pytest.mark.parametrize("name", ["flash_fwd_tf32x3<128>",
                                  "flash_fwd_tf32x3<256>"])
def test_a_spilling_f32_forward_fails_the_build_check(name):
    """A warp holds o's 128 columns (64 f32 a thread) beside S and P's
    split fragments: a build where that spills fails."""
    report = chip_smoke.parse_cuobjdump(_dump(wide_spills=name))
    assert report[name]["stack_bytes"] == 24
    assert chip_smoke.build_failures(report) == [
        f"{name}: spills (stack 24 bytes, 1 local loads/stores)"]


def test_an_f32_forward_without_tf32_mma_fails():
    """A build whose f32 forward multiplies on the CUDA cores (no TF32
    HMMA in its SASS) fails for every instance, and the f32-out forward's
    bf16 HMMA is not taken for it."""
    report = chip_smoke.parse_cuobjdump(_dump(f32fwd_mma=False))
    assert report["flash_fwd_tc<128,f32>"]["tensor_core_ops"] == 6
    assert chip_smoke.build_failures(report) == [
        f"{name}: no tensor-core instructions in its SASS"
        for name in chip_smoke.F32_FWD_INSTANCES]


def test_a_spilling_paged_kernel_fails_the_build_check():
    """The paged kernels need no tensor-core instructions, but a spill
    (a stack frame or a local load / store) fails them."""
    report = chip_smoke.parse_cuobjdump(_dump(paged_stack=8,
                                              paged_spills=True))
    row = report["paged_partial<f32,i8,true,8,2>"]
    assert row["stack_bytes"] == 8 and row["local_ops"] == 1
    assert chip_smoke.build_failures(report) == [
        "paged_partial<f32,i8,true,8,2>: spills (stack 8 bytes, 1 local "
        "loads/stores)"]


@pytest.mark.parametrize("name", ["paged_partial", "paged_combine"])
def test_a_library_without_a_paged_kernel_fails(name):
    report = {k: r for k, r in chip_smoke.parse_cuobjdump(_dump()).items()
              if not k.startswith(name)}
    assert chip_smoke.build_failures(report) == [
        f"{name}: not in the library"]


def test_a_report_without_resource_usage_is_not_taken_for_no_spills():
    """SASS alone leaves the stack unknown, and unknown is not zero."""
    text = _dump()
    report = chip_smoke.parse_cuobjdump(text[text.index("code for sm_90a"):])
    assert report["flash_fwd_tc<128>"]["stack_bytes"] is None
    assert any("spills" in b for b in chip_smoke.build_failures(report))


def test_the_report_needs_only_the_library(monkeypatch):
    """No build log is read: a reused library (``build_log`` empty)
    reports its spills all the same."""
    from vtpu_torch.ops import _build

    monkeypatch.setattr(_build, "build_log", "")
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        return subprocess.CompletedProcess(
            cmd, 0, _dump(dkv_stack=16, dkv_spills=True), "")

    monkeypatch.setattr(chip_smoke.subprocess, "run", fake_run)
    report = chip_smoke.kernel_build_report("/lib/libk.so", "/cuda/bin")
    assert calls == [["/cuda/bin/cuobjdump", "-res-usage", "-sass",
                      "/lib/libk.so"]]
    assert report["flash_dkv_tc<128>"]["stack_bytes"] == 16
    assert chip_smoke.build_failures(report)


@pytest.mark.parametrize("codec", ["int8", "int4", "fp8"])
def test_wire_bound_covers_the_pool_rounding(codec):
    """A stream with no all-zero block (so no block's scale is 1.0 and
    lifts the bound): its blocks quantized by the wire codec and written
    into a bf16 pool stay within ``wire_error_bound``, the codec's bound
    at the largest scale plus half a bf16 ulp of the largest adopted
    value, while the codec's bound alone (the f32 reconstruction's) is
    exceeded: the bf16 write rounds once more."""
    import torch

    from vtpu_torch.ops import quant
    from vtpu_torch.serving import wirecodec

    quantize, dequantize = {
        "int8": (quant.quantize_blockwise, quant.dequantize_blockwise),
        "int4": (quant.quantize_blockwise_int4, quant.dequantize_blockwise),
        "fp8": (quant.quantize_blockwise_fp8,
                quant.dequantize_blockwise_fp8)}[codec]
    gen = torch.Generator().manual_seed(0)
    src = (torch.randn((32, 8, 16, 128), generator=gen) * 2).to(
        torch.bfloat16)
    q, scale = quantize(src)
    assert bool((scale != 1.0).all())
    got = dequantize(q, scale, torch.bfloat16)
    err = float((got.float() - src.float()).abs().max())
    max_scale = float(scale.max())
    bound = chip_smoke.wire_error_bound(
        max_scale, float(got.float().abs().max()), codec, torch.bfloat16)
    assert err <= bound
    assert err > wirecodec.error_bound(max_scale, codec)
