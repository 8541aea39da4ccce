"""Hot-path primitives: blocked segment sums, dense spectral gridding, and
the GPU kernels under ops/pallas."""
