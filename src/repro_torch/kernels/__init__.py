# Hand-written kernels (CUDA sources in ../csrc), their plain PyTorch
# versions, the slab-dict wrappers (ops.py) and the oracles (ref.py).
