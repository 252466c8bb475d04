"""repro_torch — the PyTorch/CUDA port of `repro` (SystemDS, CIDR 2020).

Mirrors the JAX package module for module; the JAX package stays the
reference the port is tested against. This package imports torch and
never jax, nor anything of `repro`. Entry points compute on CUDA unless
the caller asks for the CPU (`LineageRuntime(device="cpu")`).
"""
