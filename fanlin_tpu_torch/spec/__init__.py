from . import content, query  # noqa: F401
