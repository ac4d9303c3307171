"""``tools/kernel_trace.py``'s readers of the compiler's output, on a
listing in the format of ``cuobjdump -sass`` and of ``nvcc -Xptxas -v``
(the tool itself runs only on the card)."""
import importlib.util
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "kernel_trace", ROOT / "tools" / "kernel_trace.py")
kt = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(kt)

SASS = """
Fatbin elf code:
================
arch = sm_90a

\tcode for sm_90a
\t\tFunction : _Z3qdqPf
\t.headerflags\t@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;     /* 0x00000a00ff017b82 */
                                                              /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;         /* 0x0000000000007919 */
        /*0020*/                   FADD R2, R2, R3 ;
        /*0030*/                   NOP ;
        /*0040*/               @P0 BRA 0x20 ;
        /*0050*/                   EXIT ;
        /*0060*/                   BRA 0x60;
\t\tFunction : _Z5otherv
        /*0000*/                   MOV R1, R2 ;
.L_x_3:
        /*0010*/                   FADD R2, R2, R3 ;
        /*0020*/                   FMUL R2, R2, R3 ;
        /*0030*/               @!P0 BRA `(.L_x_3) ;
        /*0040*/                   EXIT ;
"""

PTXAS = """ptxas info    : Compiling entry function '_Z3qdqPf' for 'sm_90a'
ptxas info    : Function properties for _Z3qdqPf
    8 bytes stack frame, 24 bytes spill stores, 20 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 400 bytes smem
ptxas info    : Compiling entry function '_Z5otherv' for 'sm_90a'
ptxas info    : Used 30 registers
"""


def test_sass_functions_loops_and_counts():
    funcs = kt.sass_functions(SASS)
    assert sorted(funcs) == ["_Z3qdqPf", "_Z5otherv"]
    # NOPs and labels are not instructions; the self-branch at the end
    # closes no loop
    assert kt.instruction_count(funcs["_Z3qdqPf"]) == 6
    assert kt.loops(funcs["_Z3qdqPf"]) == [
        {"from": "0x20", "to": "0x40", "instructions": 2}]
    assert kt.instruction_count(funcs["_Z5otherv"]) == 5
    assert kt.loops(funcs["_Z5otherv"]) == [
        {"from": "0x10", "to": "0x30", "instructions": 3}]


def test_ptxas_entries():
    got = kt.ptxas_entries(PTXAS)
    assert got["_Z3qdqPf"] == [
        "8 bytes stack frame, 24 bytes spill stores, 20 bytes spill loads",
        "Used 64 registers, used 1 barriers, 400 bytes smem"]
    assert got["_Z5otherv"] == ["Used 30 registers"]
