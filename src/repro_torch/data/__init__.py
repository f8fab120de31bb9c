from .graphs import make_power_law_graph, BENCHMARK_GRAPHS, make_benchmark_graph  # noqa: F401
from .graphs import seed_splits, seed_batches  # noqa: F401
from .tokens import token_batch_fn  # noqa: F401
