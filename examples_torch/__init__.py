"""The example scripts of ``examples/`` driving the PyTorch/CUDA port,
``nf_tpu_torch``: one twin per script, with its CLI flag for flag and the
same defaults, plus ``--device`` (the card by default, ``--device cpu``
for the plain PyTorch path).

    python examples_torch/neural_spline_flow.py [--iters 2000] [--device cpu]

The directory is a package so that its modules (``_utils``,
``neural_spline_flow``, ...) never collide with the JAX scripts' modules
of the same names: import a twin as ``examples_torch.<name>``.
"""
