from .builders import (
    build_circular_nsf,
    build_conditional_nsf,
    build_glow_multiscale,
    build_image_nsf,
    build_maf,
    build_nsf,
    build_planar_stack,
    build_radial_stack,
    build_realnvp,
    build_residual,
)

__all__ = ["build_circular_nsf", "build_conditional_nsf",
           "build_glow_multiscale", "build_image_nsf", "build_maf",
           "build_nsf", "build_planar_stack", "build_radial_stack",
           "build_realnvp", "build_residual"]
