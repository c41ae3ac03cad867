"""Jolt's 19 uniform R1CS constraints in condition·(left−right) = 0 form.

Exact transliteration of the constraint algebra (NOT the code) from the
reference (src/zkvm/r1cs/constraints.zig:214-560) which itself mirrors Jolt's
constraints.rs. Each linear combination is a (constant, [(input, coeff), ...])
pair over the 43 cycle inputs; coefficients are small ints except the 2^64
two's-complement offset in RightLookupSub.

FIRST/SECOND group split drives the univariate-skip domain assignment
(first group: boolean guards, small Bz; second group: wide Bz).
"""

from __future__ import annotations

from ..field.params import FR
from .inputs import Inp, NUM_INPUTS, TWO64

P = FR.p

# LC = (constant, ((input, coeff), ...))
LC = tuple


def _lc(constant=0, *terms) -> LC:
    return (constant, tuple(terms))


ONE = _lc(1)
ZERO = _lc(0)


def lc_eval(lc: LC, w: list[int]) -> int:
    c, terms = lc
    acc = c
    for idx, coeff in terms:
        acc += coeff * w[idx]
    return acc % P


# (condition, left, right) — order matches UNIFORM_CONSTRAINTS exactly
CONSTRAINTS: list[tuple[LC, LC, LC]] = [
    # 0 RamAddrEqRs1PlusImmIfLoadStore
    (_lc(0, (Inp.FlagLoad, 1), (Inp.FlagStore, 1)),
     _lc(0, (Inp.RamAddress, 1)),
     _lc(0, (Inp.Rs1Value, 1), (Inp.Imm, 1))),
    # 1 RamAddrEqZeroIfNotLoadStore
    (_lc(1, (Inp.FlagLoad, -1), (Inp.FlagStore, -1)),
     _lc(0, (Inp.RamAddress, 1)), ZERO),
    # 2 RamReadEqRamWriteIfLoad
    (_lc(0, (Inp.FlagLoad, 1)),
     _lc(0, (Inp.RamReadValue, 1)), _lc(0, (Inp.RamWriteValue, 1))),
    # 3 RamReadEqRdWriteIfLoad
    (_lc(0, (Inp.FlagLoad, 1)),
     _lc(0, (Inp.RamReadValue, 1)), _lc(0, (Inp.RdWriteValue, 1))),
    # 4 Rs2EqRamWriteIfStore
    (_lc(0, (Inp.FlagStore, 1)),
     _lc(0, (Inp.Rs2Value, 1)), _lc(0, (Inp.RamWriteValue, 1))),
    # 5 LeftLookupZeroUnlessAddSubMul
    (_lc(0, (Inp.FlagAddOperands, 1), (Inp.FlagSubtractOperands, 1), (Inp.FlagMultiplyOperands, 1)),
     _lc(0, (Inp.LeftLookupOperand, 1)), ZERO),
    # 6 LeftLookupEqLeftInputOtherwise
    (_lc(1, (Inp.FlagAddOperands, -1), (Inp.FlagSubtractOperands, -1), (Inp.FlagMultiplyOperands, -1)),
     _lc(0, (Inp.LeftLookupOperand, 1)), _lc(0, (Inp.LeftInstructionInput, 1))),
    # 7 RightLookupAdd
    (_lc(0, (Inp.FlagAddOperands, 1)),
     _lc(0, (Inp.RightLookupOperand, 1)),
     _lc(0, (Inp.LeftInstructionInput, 1), (Inp.RightInstructionInput, 1))),
    # 8 RightLookupSub (2^64 two's-complement offset)
    (_lc(0, (Inp.FlagSubtractOperands, 1)),
     _lc(0, (Inp.RightLookupOperand, 1)),
     _lc(TWO64, (Inp.LeftInstructionInput, 1), (Inp.RightInstructionInput, -1))),
    # 9 RightLookupEqProductIfMul
    (_lc(0, (Inp.FlagMultiplyOperands, 1)),
     _lc(0, (Inp.RightLookupOperand, 1)), _lc(0, (Inp.Product, 1))),
    # 10 RightLookupEqRightInputOtherwise
    (_lc(1, (Inp.FlagAddOperands, -1), (Inp.FlagSubtractOperands, -1),
         (Inp.FlagMultiplyOperands, -1), (Inp.FlagAdvice, -1)),
     _lc(0, (Inp.RightLookupOperand, 1)), _lc(0, (Inp.RightInstructionInput, 1))),
    # 11 AssertLookupOne
    (_lc(0, (Inp.FlagAssert, 1)),
     _lc(0, (Inp.LookupOutput, 1)), ONE),
    # 12 RdWriteEqLookupIfWriteLookupToRd
    (_lc(0, (Inp.WriteLookupOutputToRD, 1)),
     _lc(0, (Inp.RdWriteValue, 1)), _lc(0, (Inp.LookupOutput, 1))),
    # 13 RdWriteEqPCPlusConstIfWritePCtoRD
    (_lc(0, (Inp.WritePCtoRD, 1)),
     _lc(0, (Inp.RdWriteValue, 1)),
     _lc(4, (Inp.UnexpandedPC, 1), (Inp.FlagIsCompressed, -2))),
    # 14 NextUnexpPCEqLookupIfShouldJump
    (_lc(0, (Inp.ShouldJump, 1)),
     _lc(0, (Inp.NextUnexpandedPC, 1)), _lc(0, (Inp.LookupOutput, 1))),
    # 15 NextUnexpPCEqPCPlusImmIfShouldBranch
    (_lc(0, (Inp.ShouldBranch, 1)),
     _lc(0, (Inp.NextUnexpandedPC, 1)),
     _lc(0, (Inp.UnexpandedPC, 1), (Inp.Imm, 1))),
    # 16 NextUnexpPCUpdateOtherwise
    (_lc(1, (Inp.ShouldBranch, -1), (Inp.FlagJump, -1)),
     _lc(0, (Inp.NextUnexpandedPC, 1)),
     _lc(4, (Inp.UnexpandedPC, 1), (Inp.FlagDoNotUpdateUnexpandedPC, -4), (Inp.FlagIsCompressed, -2))),
    # 17 NextPCEqPCPlusOneIfInline
    (_lc(0, (Inp.FlagVirtualInstruction, 1)),
     _lc(0, (Inp.NextPC, 1)), _lc(1, (Inp.PC, 1))),
    # 18 MustStartSequenceFromBeginning
    (_lc(0, (Inp.NextIsVirtual, 1), (Inp.NextIsFirstInSequence, -1)),
     ONE, _lc(0, (Inp.FlagDoNotUpdateUnexpandedPC, 1))),
]

NUM_CONSTRAINTS = 19

FIRST_GROUP_INDICES = [1, 2, 3, 4, 5, 6, 11, 14, 17, 18]
SECOND_GROUP_INDICES = [0, 7, 8, 9, 10, 12, 13, 15, 16]


def constraint_eval(i: int, w: list[int]) -> int:
    """Az·Bz for constraint i: condition · (left − right) mod p."""
    cond, left, right = CONSTRAINTS[i]
    return lc_eval(cond, w) * ((lc_eval(left, w) - lc_eval(right, w)) % P) % P


def check_witness(w: list[int]) -> list[int]:
    """Indices of violated constraints (empty = satisfied)."""
    return [i for i in range(NUM_CONSTRAINTS) if constraint_eval(i, w) != 0]
