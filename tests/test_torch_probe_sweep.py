"""The SASS reader (``tools/sass.py``) and the sweep probe's loop finder
(``tools/probe_sweep.py``) on a listing written in ``cuobjdump -sass``'s
format: functions, labels, predicates, backward branches, innermost loops
and the per-row opcode counts that ``chip_smoke.py``'s sweep SASS line
prints and checks. No card or JAX needed."""

import pytest

pytest.importorskip("torch")

from raytracing_tpu_torch.tools import probe_sweep, sass  # noqa: E402

_LISTING = """
\tcode for sm_90a
\t\tFunction : _Z12regen_stagedILb0ELi0EEvv
\t.headerflags\t@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x000 */
        /*0010*/                   MOV R2, RZ ;
.L_x_1:
        /*0020*/                   LDS.128 R4, [R3] ;
        /*0030*/                   LDS.128 R8, [R3+0x10] ;
        /*0040*/                   FMUL R5, R4, R4 ;
        /*0050*/                   MUFU.RSQ R6, R5 ;
        /*0060*/                   LDS.128 R4, [R3+0x20] ;
        /*0070*/                   LDS.128 R8, [R3+0x30] ;
        /*0080*/                   FADD R5, R4, R8 ;
        /*0090*/                   MUFU.RSQ R6, R5 ;
        /*00a0*/                   NOP ;
        /*00b0*/              @!P1 BRA `(.L_x_1) ;
        /*00c0*/                   LDG.E.128 R4, desc[UR4][R2.64] ;
        /*00d0*/                   MUFU.RSQ R6, R4 ;
        /*00e0*/               @P0 CALL.REL.NOINC `($__internal_sqrt) ;
        /*00f0*/               @P2 BRA 0xc0 ;
        /*0100*/                   MUFU.RCP R7, R6 ;
        /*0110*/                   BRA.U !UP0, 0x10 ;
        /*0120*/                   EXIT ;
\t\tFunction : _Z5otherv
        /*0000*/                   FADD R1, R1, R1 ;
        /*0010*/                   BRA 0x0 ;
"""


def test_functions_resolve_labels_and_drop_predicates():
    funcs = sass.functions(_LISTING)
    assert list(funcs) == ["_Z12regen_stagedILb0ELi0EEvv", "_Z5otherv"]
    insns = dict(funcs["_Z12regen_stagedILb0ELi0EEvv"])
    assert insns[0xB0] == "BRA `(0x20)"
    assert insns[0xE0].startswith("CALL.REL.NOINC")
    assert len(funcs["_Z5otherv"]) == 2


@pytest.mark.parametrize("text,op", [
    ("LDS.128 R4, [R3]", "LDS.128"), ("LDS R4, [R3]", "LDS"),
    ("LDS.U.64 R4, [R3]", "LDS.64"), ("LDG.E.128 R4, desc[UR4][R2.64]",
                                      "LDG.128"),
    ("MUFU.RSQ R6, R5", "MUFU.RSQ"), ("ISETP.GT.U32.AND P0, PT, R0, R1, PT",
                                      "ISETP"),
    ("FADD.FTZ R1, R2, R3", "FADD"),
])
def test_opcode_names(text, op):
    assert sass.opcode(text) == op


def test_sweep_loops_are_innermost_with_a_root_a_row():
    insns = sass.functions(_LISTING)["_Z12regen_stagedILb0ELi0EEvv"]
    loops = probe_sweep.sweep_loops(insns)
    # The outer loop (0x10-0x110) holds the others; the function's other
    # function-wide loop has no root.
    assert [(lp["rows_per_trip"], lp["memory"]) for lp in loops] == [
        (2, "shared"), (1, "global")]
    shared = loops[0]
    assert shared["instructions_per_row"] == 4.5  # NOP left out
    assert shared["opcodes_per_row"] == {
        "LDS.128": 2.0, "MUFU.RSQ": 1.0, "FMUL": 0.5, "FADD": 0.5,
        "BRA": 0.5}
    assert loops[1]["opcodes_per_row"]["CALL"] == 1.0
    assert probe_sweep.sweep_loops(sass.functions(_LISTING)[
        "_Z5otherv"]) == []


def test_backward_branches_plain_or_uniform():
    # probe_dtype's rate loops count plain BRA back-edges only.
    insns = sass.functions(_LISTING)["_Z12regen_stagedILb0ELi0EEvv"]
    assert sass.backward_branches(insns) == [(0x20, 0xB0), (0xC0, 0xF0),
                                             (0x10, 0x110)]
    assert sass.backward_branches(insns, uniform=False) == [(0x20, 0xB0),
                                                            (0xC0, 0xF0)]
