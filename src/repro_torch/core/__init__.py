from .plan_cache import (  # noqa: F401
    PartitionConfig,
    PartitionPlan,
    PlanCache,
    build_partition_plan,
    graph_content_hash,
)
