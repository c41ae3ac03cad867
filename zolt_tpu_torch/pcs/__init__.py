from . import dory, hyperkzg, mock, srs

__all__ = ["dory", "hyperkzg", "mock", "srs"]
