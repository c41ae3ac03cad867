"""The benchmark's plain reference, which shares no code with the program:
an RV64IM interpreter, a verifier of compat proofs, and the comparison that
decides a run's `correct`."""
