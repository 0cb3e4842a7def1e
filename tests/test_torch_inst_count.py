"""tools/inst_count.instrument without a GPU: the per-thread instruction
counter it adds to one entry of a PTX module.

On a small module of two entries, written as nvcc writes PTX: the counters
(one per kind of instruction: integer, memory, other) are declared and
zeroed in the instrumented entry only, each basic block (after a label,
after a branch) first adds its own count of each kind (the declarations
of a nested scope are not instructions), every return first adds the
thread's totals to the global ``ed_icount[3]``, and the static count is
the entry's instruction count by kind. A call, whose instructions would
go uncounted, is refused. The SASS side: a ``cuobjdump -sass`` listing
parsed into one function's static counts by the same kinds. And each
entry's number of parameters, which the instrumented launch checks its
arguments against.
"""
import re

import pytest

from eldorado_tpu_torch.tools import inst_count as I

PTX = """//
// Generated by NVIDIA NVVM Compiler
.version 8.7
.target sm_90a
.address_size 64

\t// .globl\tother
.visible .entry other(
\t.param .u32 other_param_0
)
{
\t.reg .b32 \t%r<2>;

\tld.param.u32 \t%r1, [other_param_0];
\tret;

}
\t// .globl\tkern
.visible .entry kern(
\t.param .u64 kern_param_0,
\t.param .u32 kern_param_1
)
.maxntid 32, 1, 1
{
\t.reg .pred \t%p<2>;
\t.reg .b32 \t%r<6>;
\t.reg .b64 \t%rd<3>;

\tld.param.u64 \t%rd1, [kern_param_0];
\tld.param.u32 \t%r1, [kern_param_1];
\tsetp.lt.s32 \t%p1, %r1, 1;
\t@%p1 bra \t$L__BB1_2;

\tld.global.v2.u32 \t{%r2, %r3}, [%rd1];   // a vector operand
\tadd.s32 \t%r4, %r2, %r3;
\t{
\t.reg .b32 %temp;
\tmov.b64 \t{%temp, %r5}, %rd1;
\t}
\tst.global.u32 \t[%rd1], %r4;

$L__BB1_2:
\tret;

}
"""


def test_instrument_counts_each_block_and_sums_at_return():
    text, static = I.instrument(PTX, "kern")
    # the entry's 3 blocks: ld.param x2, setp, bra | ld, add, mov, st | ret
    assert static == {"int": 2, "mem": 4, "other": 3}
    assert ".global .align 8 .u64 ed_icount[3];" in text
    assert text.index(".address_size") < text.index("ed_icount[3];")
    body = text[text.index(".entry kern("):]
    other = text[text.index(".entry other("):text.index(".entry kern(")]
    assert "%icnt" not in other
    code = [l.strip() for l in body.splitlines()]
    assert code.count(".reg .b64 \t%icnt<3>;") == 1
    adds = [(int(m.group(1)), int(m.group(2))) for l in code
            if (m := re.match(r"add\.s64 \t%icnt(\d), %icnt\1, (\d+);", l))]
    assert adds == [(0, 1), (1, 2), (2, 1), (0, 1), (1, 2), (2, 1), (2, 1)]
    zeros = [code.index(f"mov.u64 \t%icnt{j}, 0;") for j in range(3)]
    assert zeros == sorted(zeros)
    assert zeros[-1] < code.index("add.s64 \t%icnt0, %icnt0, 1;") \
        < code.index("ld.param.u64 \t%rd1, [kern_param_0];")
    # the branch ends a block: the next block's adds come right after it
    assert code[code.index("@%p1 bra \t$L__BB1_2;") + 1] \
        == "add.s64 \t%icnt0, %icnt0, 1;"
    ret = code.index("ret;")
    assert code[ret - 3:ret] == [
        f"red.global.add.u64 \t[ed_icount+{8 * j}], %icnt{j};"
        for j in range(3)]
    assert code[ret - 4] == "add.s64 \t%icnt2, %icnt2, 1;"


def test_entry_params_counts_each_entrys_parameters():
    """What the instrumented launch checks its arguments against."""
    assert I.entry_params(PTX, "kern") == 2
    assert I.entry_params(PTX, "other") == 1


@pytest.mark.parametrize("inst, kind", [
    ("add.s32 \t%r4, %r2, %r3;", "int"),
    ("@%p1 setp.lt.s32 \t%p1, %r1, 1;", "int"),
    ("cvt.u32.u8 \t%r1, %rs1;", "int"),
    ("ld.shared.u32 \t%r1, [%rd2+4];", "mem"),
    ("@!%p2 st.local.u32 \t[%rd3], %r1;", "mem"),
    ("red.global.add.u64 \t[%rd1], %rd2;", "mem"),
    ("mov.u32 \t%r1, %tid.x;", "other"),
    ("@%p1 bra \t$L__BB1_2;", "other"),
    ("add.f32 \t%f1, %f2, %f3;", "other"),
])
def test_classify_sorts_ptx_by_the_units_that_run_it(inst, kind):
    assert I.classify(inst) == kind


SASS = """
	code for sm_90a
		Function : _ZN2ed17fused_step_kernelILb1ELi0EEEvPKi
	.headerflags	@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
                                                            /* 0x000fe40000000800 */
        /*0010*/                   EXIT ;
		Function : _ZN2ed17fused_step_kernelILb0ELi0EEEvPKi
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   S2R R0, SR_TID.X ;
        /*0020*/                   IMAD.WIDE.U32 R2, R0, 0x4, R2 ;
        /*0030*/              @!P0 LDS R4, [R3+0x10] ;
        /*0040*/                   ISETP.GE.AND P0, PT, R0, UR4, PT ;
        /*0050*/             @!UP0 STG.E [R2.64], R4 ;
        /*0060*/                   BRA `(.L_x_1) ;
        /*0070*/                   EXIT ;
        /*0080*/                   NOP;
        /*0090*/                   NOP;
"""


def test_parse_sass_counts_one_function_by_kind():
    assert I.parse_sass(SASS, "fused_step_kernelILb0ELi0E") == {
        "int": 2, "mem": 3, "other": 3}
    assert I.parse_sass(SASS, "ILb1E") == {"int": 0, "mem": 1, "other": 1}
    with pytest.raises(ValueError, match="2 functions match"):
        I.parse_sass(SASS, "fused_step_kernel")


def test_instrument_refuses_calls_and_unknown_entries():
    with pytest.raises(ValueError, match="not in the PTX"):
        I.instrument(PTX, "nope")
    called = PTX.replace("\tadd.s32 \t%r4, %r2, %r3;",
                         "\tcall.uni \thelper, (%r2);")
    with pytest.raises(ValueError, match="calls a function"):
        I.instrument(called, "kern")
