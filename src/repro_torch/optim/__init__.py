from .adamw import adamw_init, adamw_update, clip_by_global_norm, cosine_schedule  # noqa: F401
