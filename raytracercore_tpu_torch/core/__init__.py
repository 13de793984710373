from . import color, vecmath  # noqa: F401
