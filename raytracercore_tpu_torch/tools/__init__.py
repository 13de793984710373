from . import png  # noqa: F401
from .png import read_png, write_png  # noqa: F401
