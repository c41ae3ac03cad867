from . import host

__all__ = ["host"]
