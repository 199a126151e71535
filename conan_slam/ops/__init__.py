"""Hot linear algebra of the filters, in plain jnp: XLA compiles it for the
GPU (cuBLAS / cuSOLVER for the products and factorisations, its own fused
kernels for the rest)."""
