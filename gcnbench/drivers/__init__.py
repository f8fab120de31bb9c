"""The traffic drivers. A traffic file's ``driver`` names one module here:
``train`` (full-batch SGD steps back to back). Each module has
``run(ctx) -> dict`` and a class that the control script drives seed by
seed."""
