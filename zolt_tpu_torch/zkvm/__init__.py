"""The Jolt-format prove pipeline: reference-compat mode (stages 1-7) and
sound mode (stages 1-12 and the PCS batch opening)."""
