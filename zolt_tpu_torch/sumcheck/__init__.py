from .driver import (
    ProductSumcheck,
    SumcheckProof,
    initial_claim_product,
    run_sumcheck,
    verify_sumcheck,
)

__all__ = [
    "ProductSumcheck",
    "SumcheckProof",
    "initial_claim_product",
    "run_sumcheck",
    "verify_sumcheck",
]
