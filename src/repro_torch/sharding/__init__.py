from .rules import (  # noqa: F401
    param_specs, cache_specs, set_mesh_ctx, get_mesh_ctx, clear_mesh_ctx,
    shard, shard_heads, batch_axes, resolve_spec,
)
