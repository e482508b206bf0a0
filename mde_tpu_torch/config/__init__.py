from .parsers import CommonArgParser, EvalArgParser, TrainArgParser, parse_cli

__all__ = ["CommonArgParser", "EvalArgParser", "TrainArgParser", "parse_cli"]
