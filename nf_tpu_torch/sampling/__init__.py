"""Sampling algorithms (``nf_tpu/sampling``; reference
``normflows/sampling/``)."""

from .hais import HAIS

__all__ = ["HAIS"]
