from .manager import CheckpointManager  # noqa: F401
