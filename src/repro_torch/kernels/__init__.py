# Hand-written kernels (CUDA sources in ../csrc, built by build.py), their
# plain PyTorch versions, the routing policy (router.py), the slab-dict
# wrappers (ops.py) and the oracles (ref.py).
