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


_COOP_LISTING = """
\t\tFunction : _Z12trace_stagedILb0ELi2EEvv
        /*0000*/                   MOV R2, RZ ;
        /*0010*/                   VOTE.ANY R3, PT, P0 ;
        /*0020*/                   MATCH.ANY R4, R5 ;
        /*0030*/                   REDUX.SUM R6, R7 ;
        /*0040*/                   ATOMG.E.ADD.64 R8, desc[UR4][R2.64], R6 ;
        /*0050*/                   I2F R9, R8 ;
        /*0060*/                   MUFU.RCP R9, R9 ;
        /*0070*/               @P1 BRA 0x10 ;
        /*0080*/                   LDS.128 R4, [R3] ;
        /*0090*/                   MUFU.RCP R6, R5 ;
        /*00a0*/                   MUFU.RCP R6, R5 ;
        /*00b0*/                   MUFU.RCP R6, R5 ;
        /*00c0*/                   MUFU.RCP R6, R5 ;
        /*00d0*/                   REDUX.MIN R6, R7 ;
        /*00e0*/                   REDUX.MIN R6, R7 ;
        /*00f0*/               @P2 BRA 0x80 ;
        /*0100*/                   EXIT ;
"""


def test_coop_loops_skip_the_ray_queue_refill():
    # The refill loop (an aggregated ATOMG beside a REDUX) is no sweep; the
    # cooperative triangle loop (four rows a lane, two REDUX) is.
    insns = sass.functions(_COOP_LISTING)["_Z12trace_stagedILb0ELi2EEvv"]
    loops = probe_sweep.coop_loops(insns, "MUFU.RCP")
    assert [(lp["address"], lp["rows_per_trip"], lp["redux_per_trip"])
            for lp in loops] == [(0x80, 4, 2)]


def test_backward_branches_plain_or_uniform():
    # probe_dtype's rate loops count plain BRA back-edges only.
    insns = sass.functions(_LISTING)["_Z12regen_stagedILb0ELi0EEvv"]
    assert sass.backward_branches(insns) == [(0x20, 0xB0), (0xC0, 0xF0),
                                             (0x10, 0x110)]
    assert sass.backward_branches(insns, uniform=False) == [(0x20, 0xB0),
                                                            (0xC0, 0xF0)]


def _counts_with_main(per_row: float, ops: dict | None = None,
                      branches_out: bool = False) -> dict:
    main = {"rows_per_trip": 4, "instructions_per_row": per_row,
            "opcodes_per_row": ops or {"LDS.128": 2.0},
            "memory": "shared", "branches_out": branches_out}
    return {label: {"main": main} for label in probe_sweep.MAIN_ROW_MAX}


@pytest.mark.parametrize("per_row,ops,branches_out,faulty", [
    (32.0, None, False, False),   # the lean row's most
    (31.75, None, False, False),
    (32.25, None, False, True),
    (36.0, None, False, True),    # the row_key form's row
    (31.0, None, True, True),     # a call, BSSY or BSYNC in the loop
    (31.0, {"LDS.128": 2.0, "LDS": 1.0}, False, True),
])
def test_main_row_faults_hold_the_lean_row(per_row, ops, branches_out,
                                           faulty):
    # chip_smoke.py's sweep SASS line fails on these faults of the staged
    # body's and the segment probe's main loops (``faulty``), and of the
    # two-level dense window's above its own most.
    assert probe_sweep.MAIN_ROW_MAX == {"regen": 32.0, "segment_full": 32.0,
                                        "regen_sph2l": 32.75}
    faults = probe_sweep.main_row_faults(
        _counts_with_main(per_row, ops, branches_out))
    assert ("regen" in faults) == ("segment_full" in faults) == faulty
    assert sorted(faults) == sorted(
        label for label, most in probe_sweep.MAIN_ROW_MAX.items()
        if per_row > most or branches_out or "LDS" in (ops or {}))


@pytest.mark.parametrize("per_row", [34.25, 34.5, 37.25, 37.5, 40.25])
def test_coop_row_faults_hold_the_lean_row(per_row):
    # chip_smoke.py's sweep SASS line fails on a cooperative loop of the
    # chunked bodies above its kernel's most instructions a row: the lean
    # row's counts pass, the row_key form's (40.25 two-level, 37.25 flat)
    # do not.
    assert probe_sweep.COOP_ROW_MAX == {"regen_sph2l": 37.25,
                                        "regen_chunked": 34.25}
    loop = {"rows_per_trip": 4, "redux_per_trip": 2,
            "instructions_per_row": per_row, "opcodes_per_row": {},
            "branches_out": False}
    counts = {label: {"coop": [loop]} for label in probe_sweep.COOP_ROW_MAX}
    faults = probe_sweep.coop_row_faults(counts)
    assert sorted(faults) == sorted(
        label for label, most in probe_sweep.COOP_ROW_MAX.items()
        if per_row > most)
    none = {label: {"coop": []} for label in probe_sweep.COOP_ROW_MAX}
    assert set(probe_sweep.coop_row_faults(none)) == set(
        probe_sweep.COOP_ROW_MAX)


def _tri_coop_listing(per_row: float, extra=()) -> str:
    """A two-level trace kernel whose cooperative loop sweeps four
    triangle rows a lane a trip (four ``MUFU.RCP``, two ``REDUX``, a
    ``NOP`` that is not counted) in ``per_row`` instructions a row, the
    instructions of ``extra`` among them."""
    body = ["LDS.128 R4, [R3]", *extra, *["MUFU.RCP R6, R5"] * 4,
            "REDUX.MIN.S32 UR4, R6", "REDUX.MIN.S32 UR5, R7", "NOP"]
    n_fmul = round(per_row * 4) - (len(body) - 1) - 1
    body[1:1] = ["FMUL R5, R4, R4"] * n_fmul
    lines = ["\t\tFunction : _Z12trace_stagedILb1ELi2EEvv",
             "        /*0000*/                   MOV R2, RZ ;"]
    for i, text in enumerate(body):
        lines.append(f"        /*{0x10 * (i + 1):04x}*/"
                     f"                   {text} ;")
    end = 0x10 * (len(body) + 1)
    lines.append(f"        /*{end:04x}*/               @P2 BRA 0x10 ;")
    lines.append(f"        /*{end + 0x10:04x}*/                   EXIT ;")
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("case,over,extra,fault", [
    ("at_the_most", 0.0, (), None),
    ("a_quarter_below", -0.25, (), None),
    ("one_more_a_trip", 0.25, (), "instructions a row"),
    ("tri_key_form", 75.25, (), "instructions a row"),
    ("a_call", 0.0, ("CALL.REL.NOINC `($__internal_0)",), "branch out"),
    ("a_bssy", 0.0, ("BSSY B0, 0x200",), "branch out"),
    ("a_spill_load", 0.0, ("LDL.LU R9, [R1+0x40]",), "spill"),
    ("a_spill_store", 0.0, ("STL [R1+0x40], R9",), "spill"),
])
def test_tri_coop_row_faults_hold_the_lean_triangle_row(case, over, extra,
                                                        fault):
    # chip_smoke.py's triangle SASS line fails on the two-level triangle
    # stage 1's cooperative loop (found in a listing as tri_sass_counts
    # finds it) above its kernel's most instructions a row, with a call or
    # a branch out, or with a spill in it; tri_key's form (75.0 in the
    # regen entry, 75.25 in the trace entry) does not pass.
    assert probe_sweep.TRI_COOP_ROW_MAX == {
        "regen_tri_2l": 69.25, "regen_tex_tri_2l": 69.25,
        "trace_tri_2l": 69.5, "trace_tex_tri_2l": 69.5}
    counts = {}
    for label, most in probe_sweep.TRI_COOP_ROW_MAX.items():
        per_row = over if case == "tri_key_form" else most + over
        insns = sass.functions(_tri_coop_listing(per_row, extra))[
            "_Z12trace_stagedILb1ELi2EEvv"]
        loops = probe_sweep.coop_loops(insns, "MUFU.RCP")
        assert [(lp["rows_per_trip"], lp["redux_per_trip"],
                 lp["instructions_per_row"]) for lp in loops] == [
            (4, 2, per_row)]
        counts[label] = {"coop": loops}
    faults = probe_sweep.coop_row_faults(counts,
                                         probe_sweep.TRI_COOP_ROW_MAX)
    if fault is None:
        assert faults == {}
    else:
        assert set(faults) == set(probe_sweep.TRI_COOP_ROW_MAX)
        assert all(fault in f for f in faults.values())
    none = {label: {"coop": []} for label in probe_sweep.TRI_COOP_ROW_MAX}
    assert set(probe_sweep.coop_row_faults(
        none, probe_sweep.TRI_COOP_ROW_MAX)) == set(
        probe_sweep.TRI_COOP_ROW_MAX)


def test_main_row_faults_without_a_main_loop():
    counts = {label: {"main": None} for label in probe_sweep.MAIN_ROW_MAX}
    assert set(probe_sweep.main_row_faults(counts)) == set(
        probe_sweep.MAIN_ROW_MAX)
    # The listing above: its staged loop takes 4.5 instructions a row.
    insns = sass.functions(_LISTING)["_Z12regen_stagedILb0ELi0EEvv"]
    main = probe_sweep.sweep_loops(insns)[0]
    assert not probe_sweep.main_row_faults(
        {label: {"main": main} for label in probe_sweep.MAIN_ROW_MAX})


_PTXAS = """\
ptxas info    : Compiling entry function '_Z12regen_stagedILb1ELi2EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z12regen_stagedILb1ELi2EEvv
    560 bytes stack frame, 532 bytes spill stores, 392 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 560 bytes cumulative stack size
ptxas info    : Compiling entry function '_Z12regen_stagedILb0ELi0EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z12regen_stagedILb0ELi0EEvv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 76 registers, used 1 barriers
"""


def test_registers_and_spills_from_the_compiler_report(monkeypatch):
    # probe_sweep --sass prints each counted kernel's registers and spill
    # bytes (stored, loaded) from ptxas -v's report of the build.
    from raytracing_tpu_torch.ops import _build

    monkeypatch.setitem(_build.build_info, "canned", {"ptxas": _PTXAS})
    assert _build.registers("canned") == {
        "_Z12regen_stagedILb1ELi2EEvv": 80, "_Z12regen_stagedILb0ELi0EEvv": 76}
    assert _build.spills("canned") == {
        "_Z12regen_stagedILb1ELi2EEvv": (532, 392),
        "_Z12regen_stagedILb0ELi0EEvv": (0, 0)}
