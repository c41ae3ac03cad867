from .params import FP, FR, N_LIMBS, LIMB_BITS, FieldParams, from_limbs, to_limbs
from . import limb

__all__ = ["FP", "FR", "N_LIMBS", "LIMB_BITS", "FieldParams", "from_limbs", "to_limbs", "limb"]
