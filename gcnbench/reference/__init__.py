"""The plain fp32 reference of the benchmark's cells: the Table I graph
generator and its normalisations (``graphs``), and the GCN / GraphSAGE
forward pass, loss, gradients and SGD step (``model``). Plain NumPy and
PyTorch only: nothing of ``repro_torch``, ``repro`` or ``jax``."""
