from . import constraints, inputs
from .constraints import CONSTRAINTS, FIRST_GROUP_INDICES, SECOND_GROUP_INDICES, check_witness
from .inputs import Inp, NUM_INPUTS, cycle_witness, noop_witness, witness_matrix

__all__ = [
    "constraints", "inputs", "CONSTRAINTS", "FIRST_GROUP_INDICES",
    "SECOND_GROUP_INDICES", "check_witness", "Inp", "NUM_INPUTS",
    "cycle_witness", "noop_witness", "witness_matrix",
]
