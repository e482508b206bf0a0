"""The numbers `correct` compares, each a gap between what the timed path
produced and what the plain reference gives."""

import statistics

GRADIENT_FLOOR = 1e-3  # a leaf whose reference gradient is under this share
                       # of the median leaf's moves under Adam by round-off
# the cue layer's leaves: the CueMLPs, and the stem that takes the cue channels
CUE_MLPS = ("instance_areas_fc.", "instance_absolute_sizes_fc.")
CUE_LEAVES = CUE_MLPS + ("encoder.original_model.conv_stem.",)


def leaf_gaps(program, reference, leaves):
    """Each leaf's gap of norms, |program - reference|, over the reference's
    norm of that leaf or of the median leaf, the larger. A leaf the program
    lacks reads as norm 0."""
    median = statistics.median(reference[k] for k in leaves)
    return {k: abs(program.get(k, 0.0) - reference[k]) / max(reference[k], median, 1e-30)
            for k in leaves}


def moved_leaves(first_gradient):
    """The leaves whose reference gradient is not nought to rounding."""
    median = statistics.median(first_gradient.values())
    return [k for k, v in first_gradient.items() if v >= GRADIENT_FLOOR * median]


def train_gaps(program, reference):
    """(the numbers a run reads, the look beside them) for the first
    training steps, each side given as (losses by step, first gradient
    norms by leaf, change norms by leaf). Read, over the leaves the
    reference's gradient moves: the first step's and the worst step's
    relative loss gap; the worst, the third-worst and the median leaf's gap
    of the first gradient; the worst and the median leaf's gap
    of the change; and, where the model has CueMLPs, the worst gap of the
    first gradient and of the change over the cue layer's leaves. The look:
    each step's loss gap, and which leaf is worst (PERF.md)."""
    losses, first, change = program
    ref_losses, ref_first, ref_change = reference
    moved = moved_leaves(ref_first)
    grad = leaf_gaps(first, ref_first, moved)
    moves = leaf_gaps(change, ref_change, moved)
    loss = [abs(p - r) / abs(r) for p, r in zip(losses, ref_losses, strict=True)]
    worst_grad = max(grad, key=grad.get)
    worst_change = max(moves, key=moves.get)
    ranked = sorted(grad.values(), reverse=True)
    read = {"first_loss_gap": loss[0], "loss_gap": max(loss), "grad_gap": ranked[0],
            "grad_gap_3rd": ranked[min(2, len(ranked) - 1)],
            "change_gap": moves[worst_change],
            "median_grad_gap": statistics.median(grad.values()),
            "median_change_gap": statistics.median(moves.values())}
    if any(k.startswith(CUE_MLPS) for k in ref_first):
        cue = [k for k in moved if k.startswith(CUE_LEAVES)]
        read["cue_grad_gap"] = max(grad[k] for k in cue)
        read["cue_change_gap"] = max(moves[k] for k in cue)
    look = {"loss_gap_by_step": loss, "worst_grad_leaf": worst_grad,
            "worst_change_leaf": worst_change}
    return read, look
