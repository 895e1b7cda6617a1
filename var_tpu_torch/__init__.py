"""PyTorch/CUDA port of the VAR framework for one NVIDIA H100.

The JAX package `var_tpu` is the reference this package is held against
(tests/test_torch_*.py). Nothing here imports JAX or `var_tpu`: where the
port needs framework-free code of the reference, it keeps its own copy.
Entry points run on CUDA unless the caller asks for the CPU.
"""
