"""Argparse front-end, the port's own copy of `mde_tpu/config/parsers.py`,
byte-compatible with the reference param-file surface.

The reference drives every entry point from `@file` argparse param files
(one `--key value` pair per line, split on whitespace); see
reference ArgParseWrappers/CommonArgParser.py:13-73,
TrainArgParser.py:12-49 and EvalArgParser.py:12-20. Flag names, defaults
and the file format are the JAX package's, so every params/*.txt parses to
the same namespace; on top of it sit the derived attributes the reference
computes ad hoc in train.py:587-602 / evaluate.py:170-171 (batch_size, mode,
chamfer, env-var expansion).

The port adds one flag, `--device` (default cuda; `--device cpu` runs on the
CPU, as the tests do). `--mesh_shape d,m` lays the `--distributed` world of
d·m processes out as JAX lays its devices out, with tensor parallelism over
the m model ranks (`parallel/`, `models/tp.py`); one size, or none, is data
parallelism over the world. The flags of the JAX package's TPU dispatch
(`--steps_per_dispatch`, `--hires_impl packed`) parse and change nothing:
the port runs the plain path.
"""

import argparse
import os
import sys


class CommonArgParser(argparse.ArgumentParser):
    """Arguments shared by train/eval/infer (reference CommonArgParser.py:7-73)."""

    def __init__(self, description="Common Argument Parser base class.",
                 fromfile_prefix_chars="@", conflict_handler="resolve"):
        super().__init__(description=description,
                         fromfile_prefix_chars=fromfile_prefix_chars,
                         conflict_handler=conflict_handler)

        # System setup. --gpu is kept for CLI compatibility and selects
        # nothing; --device places the run.
        self.add_argument('--gpu', default=None, type=int, help='Which gpu to use')
        self.add_argument("--device", default="cuda", type=str,
                          help="torch device to run on: cuda (default) or cpu")
        self.add_argument("--root", default=".", type=str,
                          help="Root folder to save data in")

        # Dataset setup.
        self.add_argument("--dataset", default='nyu', type=str, help="Dataset to train on")
        self.add_argument("--data_path", default='nyu/sync/', type=str, help="path to dataset")
        self.add_argument("--gt_path", default='nyu/sync/', type=str, help="path to dataset")
        self.add_argument('--filenames_file',
                          default="./train_test_inputs/nyudepthv2_train_files_with_gt.txt",
                          type=str, help='path to the filenames text file')
        self.add_argument('--data_path_eval',
                          default="nyu/official_splits/test/",
                          type=str, help='path to the data for online evaluation')
        self.add_argument('--gt_path_eval', default="nyu/official_splits/test/",
                          type=str, help='path to the groundtruth data for online evaluation')
        self.add_argument('--filenames_file_eval',
                          default="./train_test_inputs/nyudepthv2_test_files_with_gt.txt",
                          type=str, help='path to the filenames text file for online evaluation')

        self.add_argument('--input_height', type=int, help='input height', default=416)
        self.add_argument('--input_width', type=int, help='input width', default=544)
        self.add_argument('--max_depth', type=float, help='maximum depth in estimation', default=10)
        self.add_argument('--min_depth', type=float, help='minimum depth in estimation', default=1e-3)

        self.add_argument('--min_depth_eval', type=float, help='minimum depth for evaluation', default=1e-3)
        self.add_argument('--max_depth_eval', type=float, help='maximum depth for evaluation', default=10)
        self.add_argument('--garg_crop', help='if set, crops according to Garg  ECCV16', action='store_true')
        self.add_argument('--do_kb_crop', help='if set, crop input images as kitti benchmark images',
                          action='store_true')

        self.add_argument("--use_semantics", default=None, type=str, help="""
                What kind of semantic information to use. Possible values are:
                    'raw', 'glove', 'glove-25d', 'glove-25d-inst-areas',
                    'glove-25d-ade20k-places',
                    'glove-25d-ade20k-places-human-sizes'.
                    Adding "size_shuffled" to a glove-25d value uses class-shuffled embeddings;
                    adding "shuffled" to a human-sizes value uses class-shuffled object sizes.
                """)
        self.add_argument("--encoder_name", default="efficientnet-b5", type=str, help="""
                Either "efficientnet-b5" or "efficientnet-b1", or "efficientnet-b1-noAdaBins"
                for a basic bottleneck without the AdaBins module.
                """)
        self.add_argument("--use_instance_segmentation", default=None, type=str, help="""
                Whether/what instance segmentation to use. Default is "None". Can also be:
                "coco", "ade20k_swin", "ade20k_swin_human_sizes",
                "ade20k_swin_bbox", or "ade20k_swin_bbox_human_sizes".
                """)
        self.add_argument("--insertion_point", default="before-attn", type=str,
                          help='Where to insert cue information: "before-attn" or "input".')
        self.add_argument("--image", default="rgb", type=str,
                          help='What image, if any, to use: "rgb", "noise", or "none".')

        # The JAX package's extensions (absent from the reference; all
        # defaulted so reference param files parse and behave identically).
        self.add_argument("--mesh_shape", default=None, type=str,
                          help="Process grid as 'data[,model]' sizes, e.g. '8' or '4,2' "
                               "(their product is the --distributed world; model > 1 is "
                               "tensor parallelism). Default: the whole world on the data "
                               "axis.")
        self.add_argument("--compute_dtype", default="bfloat16", type=str,
                          help="Activation compute dtype (bfloat16 or float32). Params stay float32.")
        self.add_argument("--pretrained_backbone", default=None, type=str,
                          help="Path to converted EfficientNet backbone weights (.npz) "
                               "produced by scripts/convert_torch_checkpoint.py. "
                               "None = random init (no network egress at runtime).")

    def convert_arg_line_to_args(self, arg_line):
        # Reference CommonArgParser.py:69-73 — split each param-file line on
        # whitespace so '--key value' pairs can share a line.
        for arg in arg_line.split():
            if not arg.strip():
                continue
            yield str(arg)


class TrainArgParser(CommonArgParser):
    """Training-specific arguments (reference TrainArgParser.py:7-49)."""

    def __init__(self, description="Training script argument parser class.",
                 fromfile_prefix_chars="@", conflict_handler="resolve"):
        super().__init__(description=description,
                         fromfile_prefix_chars=fromfile_prefix_chars,
                         conflict_handler=conflict_handler)

        self.add_argument("--workers", default=11, type=int, help="Number of workers for data loading")
        self.add_argument("--distributed", action="store_true",
                          help="Multi-process flag. Without a torchrun environment the run "
                               "is one process.")

        self.add_argument("--resume", default='', type=str, help="Resume from checkpoint")
        self.add_argument("--notes", default='', type=str, help="Wandb notes")
        self.add_argument("--tags", default='sweep', type=str, help="Wandb tags")

        self.add_argument('--epochs', default=25, type=int, help='number of total epochs to run')
        self.add_argument('--bs', default=16, type=int, help='batch size')
        self.add_argument("--use_new_batching", default=False, action="store_true",
                          help="If set, 'bs' is the per-device batch (global = bs * n_devices). "
                               "If unset (reference default), 'bs' is the global batch split "
                               "across devices (reference train.py:286-293).")
        self.add_argument('--validate-every', '--validate_every', default=100, type=int,
                          help='validation period')
        self.add_argument("--name", default="UnetAdaptiveBins")

        self.add_argument('--n-bins', '--n_bins', default=80, type=int,
                          help='number of bins/buckets to divide depth range into')

        self.add_argument('--lr', '--learning-rate', default=0.000357, type=float, help='max learning rate')
        self.add_argument("--same-lr", '--same_lr', default=False, action="store_true",
                          help="Use same LR for all param groups")
        # The reference *builds* an encoder lr/10 group (train.py:345-354),
        # but torch OneCycleLR with a scalar max_lr overwrites every group's
        # lr each step, so uniform lr (factor 1.0) is the parity default and
        # 0.1 opts into the upstream-intended split.
        self.add_argument('--encoder-lr-factor', '--encoder_lr_factor', default=1.0,
                          type=float,
                          help='update-scale factor for encoder params (1.0 = uniform lr)')
        self.add_argument('--div-factor', '--div_factor', default=25, type=float, help="Initial div factor for lr")
        self.add_argument('--final-div-factor', '--final_div_factor', default=100, type=float,
                          help="final div factor for lr")
        self.add_argument('--wd', '--weight-decay', default=0.1, type=float, help='weight decay')
        self.add_argument('--w_chamfer', '--w-chamfer', default=0.1, type=float,
                          help="weight value for chamfer loss")

        self.add_argument("--norm", default="linear", type=str,
                          help="Type of norm/competition for bin-widths",
                          choices=['linear', 'softmax', 'sigmoid'])

        self.add_argument('--do_random_rotate', default=True,
                          help='if set, will perform random rotation for augmentation',
                          action='store_true')
        self.add_argument('--degree', type=float, help='random rotation maximum degree', default=2.5)
        self.add_argument('--use_right', help='if set, will randomly use right images when train on KITTI',
                          action='store_true')

        self.add_argument('--eigen_crop', default=True, help='if set, crops according to Eigen NIPS14',
                          action='store_true')

        # Seed for reproducible runs.
        self.add_argument('--seed', default=42, type=int, help='global RNG seed')
        # Activation checkpointing policy (the JAX package's remat); the
        # port parses it and runs without.
        self.add_argument('--remat', default='none', choices=['none', 'encoder'],
                          help='activation checkpointing policy for training')
        # The hand-written kernels for the hot ops, on by default;
        # BooleanOptionalAction also provides --no-use_* opt-outs. In the
        # port they are the CUDA kernels of csrc/ (kernels/).
        self.add_argument('--use_pallas_chamfer', default=True,
                          action=argparse.BooleanOptionalAction,
                          help='use the chamfer kernel in the train step')
        self.add_argument('--use_fused_head', default=True,
                          action=argparse.BooleanOptionalAction,
                          help='fuse conv_out+softmax+bin-centers into one kernel '
                               '(skips the round-trip of the bin logits)')
        # The JAX package's dispatch granularity (N steps in one TPU
        # dispatch); the port parses it and runs one step at a time.
        self.add_argument('--steps_per_dispatch', default=1, type=int,
                          help='train steps fused into one device dispatch')
        # Gradient accumulation: K>1 splits each batch into K sequential
        # micro-batches and applies the mean gradient once.
        self.add_argument('--accum_steps', default=1, type=int,
                          help='gradient-accumulation micro-steps per batch')
        # The JAX package's W-packed stage-0 layout for the TPU's lanes; the
        # port parses it and runs the plain layout.
        self.add_argument('--hires_impl', default='packed',
                          choices=['native', 'packed'],
                          help='encoder high-res layout: packed = W-packed '
                               'stage 0')


class EvalArgParser(CommonArgParser):
    """Eval-specific arguments (reference EvalArgParser.py:7-20).

    Note the deliberate default differences vs TrainArgParser: n_bins 256 here
    vs 80 for train, and eigen_crop defaults False here vs True for train.
    """

    def __init__(self, description="Evaluation script argument parser class",
                 fromfile_prefix_chars="@", conflict_handler="resolve"):
        super().__init__(description=description,
                         fromfile_prefix_chars=fromfile_prefix_chars,
                         conflict_handler=conflict_handler)

        self.add_argument('--n-bins', '--n_bins', default=256, type=int,
                          help='number of bins/buckets to divide depth range into')
        # Eval defaults to float32, as the reference evaluates.
        self.set_defaults(compute_dtype="float32")
        self.add_argument('--eval_batch_size', default=1, type=int,
                          help='eval frames per step (the reference is fixed at 1; '
                               'metrics stay per-image exact)')
        self.add_argument('--save-dir', '--save_dir', default=None, type=str,
                          help='Store predictions in folder')
        self.add_argument('--checkpoint_path', '--checkpoint-path', type=str, required=True,
                          help="checkpoint file to use for prediction")
        self.add_argument('--eigen_crop', help='if set, crops according to Eigen NIPS14', action='store_true')


def _expand_paths(args):
    # Reference train.py:592-597 — allow $HOME, $TMPDIR etc. in path args.
    for key in ("root", "data_path", "gt_path", "data_path_eval", "gt_path_eval"):
        if hasattr(args, key) and getattr(args, key) is not None:
            setattr(args, key, os.path.expandvars(getattr(args, key)))
    return args


def parse_cli(parser, argv=None, mode="train"):
    """Parse CLI args with the reference's single-param-file convention.

    `python train.py params.txt` is rewritten to `@params.txt`
    (reference train.py:581-585), then the derived attributes from
    train.py:587-590 / evaluate.py:170-171 are attached.
    """
    argv = sys.argv[1:] if argv is None else argv
    if argv and not argv[0].startswith('-'):
        # param file first, optional CLI overrides after
        # (e.g. `train.py params.txt --resume latest`)
        args = parser.parse_args(['@' + argv[0]] + list(argv[1:]))
    else:
        args = parser.parse_args(argv)

    args.mode = mode
    if mode == "train":
        args.batch_size = args.bs
        args.num_threads = args.workers
        args.chamfer = args.w_chamfer > 0
    else:
        args.distributed = False
    _expand_paths(args)
    return args
