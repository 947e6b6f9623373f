from .builders import build_circular_nsf, build_nsf

__all__ = ["build_circular_nsf", "build_nsf"]
