from .processor import Engine, ProcessError  # noqa: F401
