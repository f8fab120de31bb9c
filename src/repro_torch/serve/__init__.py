from .engine import Request, ServeEngine  # noqa: F401
from .fleet import FleetGraphEngine, MultihostGraphEngine  # noqa: F401
from .graph_engine import GraphRequest, GraphServeEngine  # noqa: F401
from .scheduler import BatchScheduler, ClassSpec, QueueFullError, WorkItem  # noqa: F401
