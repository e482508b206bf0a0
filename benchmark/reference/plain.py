"""The plain reference run the way a cell's timed path runs the program: the
first training steps of a configuration on given batches, in the precision
the configuration states (`compute_dtype`: "bfloat16" is autocast over
float32 parameters, as the published training runs; float32 is computed
with TF32 off), unless `lower` names the lower precision of a control:
"bf16" (autocast) or "fp8" (bf16 autocast with every conv and linear
operand rounded to float8 e4m3 under a per-tensor scale: a bf16
configuration's step one precision lower). Settings come from the
configuration file, never from the program.
"""

import contextlib
from pathlib import Path

import numpy as np
import torch

from . import adabins as ref

DATA = Path(__file__).resolve().parents[2] / "data"
TABLES = {"semantics": "ade20k_150_classes_glove_twitter_27b_25d_embeddings.npy",
          "instances": "ade20k_places_classes_glove_twitter_27b_25d_embeddings.npy",
          "human_sizes": "ade20k_classes_abs_sizes.npy"}


def model(config, device="meta"):
    with torch.device(device):
        return ref.AdaBins(config["n_bins"], config["min_depth"], config["max_depth"],
                           semantics=config.get("use_semantics"),
                           instances=config.get("use_instance_segmentation"))


def has_cues(config):
    return bool(config.get("use_semantics") or config.get("use_instance_segmentation"))


def cue_tables(device):
    return {k: torch.from_numpy(np.load(DATA / f).astype(np.float32)).to(device)
            for k, f in TABLES.items()}


@contextlib.contextmanager
def precision(lower):
    """TF32 off, and the control's rounding of conv and linear operands,
    for a whole run."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    ref.Quant.fn = ref.fp8 if lower == "fp8" else None
    try:
        yield
    finally:
        ref.Quant.fn = None
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def autocast(config, lower, device):
    """bf16 autocast where the configuration or the control states it, for
    one step's forward. Each step takes a region of its own: autocast keeps
    its casts of the parameters while a region lasts, and would hand a later
    step the first step's weights."""
    bf16 = config.get("compute_dtype") == "bfloat16" or lower in ("bf16", "fp8")
    return torch.autocast(torch.device(device).type, dtype=torch.bfloat16, enabled=bf16)


def leaf_norms(tensors):
    names = list(tensors)
    norms = torch.stack(torch._foreach_norm([tensors[k].float() for k in names])).cpu()
    return dict(zip(names, norms.tolist()))


def train_steps(config, weights, batches, seed, device, lower=None, half_batch=False):
    """The configuration's training steps on `batches`, from `weights`:
    (loss of each step, the first clipped gradient's norm by leaf, the
    parameters' change over the steps by leaf). `half_batch` leaves out
    half of each batch, a fault."""
    net = model(config, device)
    net.load_state_dict(weights, strict=True)
    net.train()
    params = dict(net.named_parameters())
    opt = ref.AdamW(params.values(), config["wd"])
    total = config["epochs"] * config["steps_per_epoch"]
    tables = cue_tables(device) if has_cues(config) else None
    start = {k: p.detach().clone() for k, p in params.items()}
    losses, first = [], None
    with precision(lower):
        for k, batch in enumerate(batches):
            if half_batch:
                batch = {name: v[:v.shape[0] // 2] for name, v in batch.items()}
            gen = torch.Generator(device=device).manual_seed(ref.dropout_seed(seed, k))
            with autocast(config, lower, device):
                cues = (ref.embed_cues(batch, tables, config["use_instance_segmentation"])
                        if tables is not None else None)
                edges, pred = net(batch["image"], cues, gen)
                depth = batch["depth"]
                loss = (ref.silog(pred.float(), depth, config["min_depth"])
                        + config["w_chamfer"] * ref.chamfer(edges.float(), depth))
            net.zero_grad(set_to_none=True)
            loss.backward()
            grads = opt.clip_grads()
            if k == 0:
                first = leaf_norms(dict(zip(params, grads)))
            lr, beta1 = ref.onecycle(k, total, config["lr"], config["div_factor"],
                                     config["final_div_factor"])
            opt.step(grads, lr, beta1)
            losses.append(loss.item())
    change = leaf_norms({k: p.detach() - start[k] for k, p in params.items()})
    return losses, first, change

