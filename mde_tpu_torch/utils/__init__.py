from .misc import colorize
from .running_average import RunningAverage, RunningAverageDict

__all__ = ["colorize", "RunningAverage", "RunningAverageDict"]
