"""Single-device engines for the wide sumcheck rounds (torch tensors)."""
