"""deCSVM in PyTorch: the port of the JAX package ``repro`` to PyTorch and
hand-written CUDA kernels for Hopper (H100).

``repro_torch.core`` holds Algorithm 1 (data, losses, solver, drivers,
the lambda path, the decentralized engines); ``repro_torch.kernels`` the
CUDA kernels, their plain torch versions and their wrappers;
``repro_torch.models`` and ``repro_torch.serving`` the LM seed stack and
its serving engines; ``repro_torch.optim`` the decentralized CSVM head on
frozen backbone features.  The package imports torch and numpy only — never jax and
never the JAX package.
"""
