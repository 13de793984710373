from . import shard  # noqa: F401
from .shard import make_train_loop, make_train_step  # noqa: F401
