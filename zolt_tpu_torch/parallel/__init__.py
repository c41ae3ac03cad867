"""The engines for the wide sumcheck rounds (torch tensors), on one device
or sharded over a mesh of devices."""

from .mesh import (
    AXIS,
    make_mesh,
    make_sharded_product_round,
    shard_table,
    sharded_sumcheck_prove,
)

__all__ = ["AXIS", "make_mesh", "make_sharded_product_round", "shard_table",
           "sharded_sumcheck_prove"]
