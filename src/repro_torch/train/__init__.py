from .step import make_train_step, make_serve_step, TrainState  # noqa: F401
from .loop import train_loop  # noqa: F401
