from .logging import SummaryLogger
from .misc import colorize, count_parameters, denormalize, setup_exp_dir
from .pointcloud import PointCloudHelper, b64_to_pil, edges
from .running_average import RunningAverage, RunningAverageDict

__all__ = ["SummaryLogger", "colorize", "count_parameters", "denormalize", "setup_exp_dir",
           "RunningAverage", "RunningAverageDict", "b64_to_pil", "edges", "PointCloudHelper"]
