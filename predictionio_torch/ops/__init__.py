"""Device ops: the batched SPD solve (with its CUDA kernels), ALS and
top-k ranking."""
