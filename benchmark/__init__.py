"""The benchmark of `laplace_jax_torch` on one NVIDIA H100: see README.md."""
