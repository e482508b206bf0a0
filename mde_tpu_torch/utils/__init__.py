from .misc import colorize

__all__ = ["colorize"]
