from . import dory, srs

__all__ = ["dory", "srs"]
