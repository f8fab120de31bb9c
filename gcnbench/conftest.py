"""The tiny sizes (``tests/conftest.py::TINY``) of the configurations added
after the tiny copy of the benchmark was written: widths that keep each
layer's order of aggregation and product as at the full size, on a graph
small enough for the CPU."""
from gcnbench.tests import conftest as tiny_copy

# sage-products: aggregate first (raw features), aggregate first (the tie),
# transform first, as 100-256-256-47 orders them
tiny_copy.TINY.setdefault("sage-products", ([12, 32, 32, 7], 600, 6000))
