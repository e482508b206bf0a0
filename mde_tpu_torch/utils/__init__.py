from .logging import SummaryLogger
from .misc import colorize, count_parameters, denormalize, setup_exp_dir
from .running_average import RunningAverage, RunningAverageDict

__all__ = ["SummaryLogger", "colorize", "count_parameters", "denormalize", "setup_exp_dir",
           "RunningAverage", "RunningAverageDict"]
