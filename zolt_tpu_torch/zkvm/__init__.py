"""The Jolt-format prove pipeline (reference-compat mode, stages 1-7)."""
