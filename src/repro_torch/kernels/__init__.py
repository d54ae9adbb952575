"""Hand-written CUDA kernels for Hopper (``csrc/``), their plain torch
versions (``csvm_update``), oracles (``ref``), wrappers with launch
counters (``ops``) and the nvcc build (``build``).

Importing needs neither nvcc nor a card: a kernel is compiled at its
first launch on a CUDA tensor.
"""
