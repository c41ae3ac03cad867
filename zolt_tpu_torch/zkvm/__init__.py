"""The provers: the Jolt-format prove pipeline (pipeline.py; reference-compat
stages 1-7, or sound stages 1-12 and the PCS batch opening), the internal
ZOLT v1 prover (internal.py) and the legacy multi-stage prover
(prover.py, stages.py, lasso.py)."""

from . import lasso, prover, stages
from .prover import MultiStageProof, prove, prove_program, verify

__all__ = ["lasso", "prover", "stages", "MultiStageProof", "prove", "prove_program", "verify"]
