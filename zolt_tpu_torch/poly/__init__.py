from . import dense, unipoly

__all__ = ["dense", "unipoly"]
