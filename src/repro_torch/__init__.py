"""deCSVM in PyTorch: the port of the JAX package ``repro`` to PyTorch and
hand-written CUDA kernels for Hopper (H100).

``repro_torch.core`` holds Algorithm 1 (data, losses, solver, drivers);
``repro_torch.kernels`` the CUDA kernels, their plain torch versions and
their wrappers.  The package imports torch and numpy only — never jax and
never the JAX package.
"""
