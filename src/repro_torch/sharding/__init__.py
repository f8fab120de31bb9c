from .rules import (  # noqa: F401
    param_specs, cache_specs, set_mesh_ctx, get_mesh_ctx, clear_mesh_ctx,
    shard, shard_heads, batch_axes, resolve_spec, placements, distribute,
    device_mesh_ctx, partitioned, mesh_coord, spec_placements,
    local_part, use_mesh, mesh_of, on_batch_axes, contiguous_stride,
    shard_offset,
)
