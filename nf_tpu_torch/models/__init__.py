from .builders import build_nsf

__all__ = ["build_nsf"]
