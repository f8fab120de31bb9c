from .graph_engine import GraphRequest, GraphServeEngine  # noqa: F401
from .scheduler import BatchScheduler, ClassSpec, QueueFullError, WorkItem  # noqa: F401
