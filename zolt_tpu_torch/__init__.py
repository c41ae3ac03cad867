"""zolt_tpu_torch — the PyTorch/CUDA port of zolt_tpu's Jolt-format prover.

The JAX package `zolt_tpu` is the reference and stays beside this one. This
package imports torch and never jax or zolt_tpu. Its main path is
`zkvm.pipeline.prove_jolt(elf, backend="device", device="cuda")`: the host
tier (emulator, witness, Dory commitments, transcript) is the JAX package's
JAX-free code carried over, and the wide sumcheck rounds of stages 1-4 run
as torch tensors through four hand-written CUDA kernels (csrc/, bound in
field/fold.py, field/evals.py and field/gruen.py). The proof bytes equal
the reference's.
"""

__version__ = "0.1.0"
