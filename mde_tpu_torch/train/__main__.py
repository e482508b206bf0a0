"""Training entry point of the port, its counterpart of the root `train.py`
(reference train.py:576-640):

    python -m mde_tpu_torch.train params/args_train_nyu_efficientnet-b1.txt [overrides]

The params file parses as `train.py` parses it; the port adds `--device`
(cuda by default; `--device cpu` trains on the CPU). A missing or failing
card is an error, not a run on the CPU. Data-parallel over N cards:

    torchrun --nproc_per_node N -m mde_tpu_torch.train params/... --distributed
"""

import sys

from ..config import TrainArgParser, parse_cli
from .driver import main_train


def main(argv=None):
    parser = TrainArgParser(
        description="Training script. Default values of all arguments are "
                    "recommended for reproducibility",
        fromfile_prefix_chars="@", conflict_handler="resolve")
    args = parse_cli(parser, argv, mode="train")
    main_train(args, interactive=sys.stdin.isatty())


if __name__ == "__main__":
    main()
