from . import kernel_body  # noqa: F401
