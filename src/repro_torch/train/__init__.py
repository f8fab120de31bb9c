from .step import make_serve_step  # noqa: F401
