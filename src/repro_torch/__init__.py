"""PyTorch + CUDA port of the Accel-GCN reproduction for NVIDIA Hopper.

Mirrors the ``repro`` package module by module (same paths, same public
names). Host preprocessing is numpy; dense work is PyTorch; the block-slab
SpMM is a CUDA kernel built for ``sm_90a`` at first use. The package never
imports JAX or ``repro``.
"""
