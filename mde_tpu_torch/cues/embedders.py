"""Cue embedders on the device, port of `mde_tpu/cues/embedders.py`
(reference ExternalInfoLoaders/SemanticsLoader.py:102-145,
InstanceSegmentationLoader.py:89-121), NCHW.

Raw label maps ride the batch onto the device as (N, 1, H, W) integers;
table gathers, the per-class area histogram and the human-size lookups run
there and give (N, C, H, W) float32 cue channels. The tables are the
`data/*.npy` files, read with numpy and kept on the device the caller names
(the card unless it asks for the CPU).

Indexing follows the JAX package's `jnp.take` and `.at[].add`, not torch's:
an index in [-n, n) selects row index mod n, so -1 is the last row; any other
index gathers a row of NaN, and the area histogram drops it. Only
ade20k-places semantics and instance labels are clamped to their background
class first; plain glove semantics are not. The gathers therefore never index
out of range, and no device-side assert can fire. Areas are counted in
float32, exact up to 2^24 pixels an image.
"""

import os
from typing import Optional

import numpy as np
import torch

_DATA_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "data")


def _load(name: str, device) -> torch.Tensor:
    table = np.load(os.path.join(_DATA_DIR, name)).astype(np.float32)
    return torch.from_numpy(table).to(device)


def semantics_table_path(use_semantics: str) -> Optional[str]:
    """Embedding table selection (reference SemanticsLoader.py:32-55)."""
    if use_semantics is None:
        return None
    if use_semantics == "glove":
        return "ade20k_150_classes_glove_840b_300d_embeddings.npy"
    if use_semantics in ("glove-25d", "glove-25d-inst-areas"):
        return "ade20k_150_classes_glove_twitter_27b_25d_embeddings.npy"
    if "ade20k-places" in use_semantics:
        if "random" in use_semantics:
            return "ade20k_places_classes_25d_embeddings_random.npy"
        if "glove-25d" in use_semantics:
            if "size_shuffled" in use_semantics:
                return "ade20k_places_classes_glove_twitter_27b_25d_embeddings_shuffled.npy"
            return "ade20k_places_classes_glove_twitter_27b_25d_embeddings.npy"
    return None


def human_sizes_path_semantics(use_semantics: str) -> Optional[str]:
    """Human-sizes table selection (reference SemanticsLoader.py:58-71)."""
    if use_semantics is None or "human-sizes" not in use_semantics:
        return None
    if "ade20k-places" not in use_semantics:
        raise ValueError("Error: human-sizes not implemented for semantics other than ade20k-places.")
    if "shuffled" in use_semantics:
        return "ade20k_classes_abs_sizes_shuffled.npy"
    return "ade20k_classes_abs_sizes.npy"


def _in_range(labels: torch.Tensor, n: int):
    """(labels that `jnp.take` resolves, the row each resolves to): [-n, n)
    wraps to index mod n; elsewhere the row is 0 and the caller masks it."""
    valid = (labels >= -n) & (labels < n)
    return valid, torch.where(valid, torch.remainder(labels, n), 0).long()


def take_rows(table: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """table (n, C) gathered by labels (N, H, W) -> (N, C, H, W), with
    `jnp.take(table, labels, axis=0)`'s semantics (module docstring)."""
    valid, rows = _in_range(labels, table.shape[0])
    out = table[rows].permute(0, 3, 1, 2)
    return torch.where(valid[:, None], out, torch.nan).contiguous()


def per_class_area_map(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Per-pixel fraction of the image that the pixel's class covers, for
    labels (N, H, W) -> (N, 1, H, W) (vectorized replacement for reference
    SemanticsLoader.py:88-99): a per-image histogram, then a gather back
    through the label map."""
    n, h, w = labels.shape
    valid, rows = _in_range(labels.reshape(n, h * w), num_classes)
    counts = torch.zeros((n, num_classes), dtype=torch.float32, device=labels.device)
    counts.scatter_add_(1, rows, valid.float())
    # by a tensor: torch's CUDA division by a host scalar multiplies by its
    # reciprocal, one rounding away from the CPU's and JAX's quotient
    frac = torch.gather(counts / torch.full_like(counts, h * w), 1, rows)
    return torch.where(valid, frac, torch.nan).reshape(n, 1, h, w)


class SemanticsEmbedder:
    """Turns raw semantic label maps (N, 1, H, W) into dense cue channels,
    laid out as the model's forward expects (reference SemanticsLoader.py:
    102-145): [embedding (25/300) | per-class area (1) | human sizes (3)]."""

    def __init__(self, args, device="cuda"):
        self.mode = args.use_semantics
        self.embeddings = None
        self.human_sizes = None
        if self.mode is None:
            return
        table = semantics_table_path(self.mode)
        if table is not None:
            self.embeddings = _load(table, device)
        sizes = human_sizes_path_semantics(self.mode)
        if sizes is not None:
            self.human_sizes = _load(sizes, device)

    def __call__(self, semantics_raw):
        """semantics_raw: (N, 1, H, W) integers. Returns (raw, embedded), raw
        clamped as the mode clamps it, or (None, None) without semantics."""
        if self.mode is None:
            return None, None
        raw = semantics_raw.to(torch.int32)
        if "ade20k-places" in self.mode:
            # 100 real classes + background 100; out of range -> background
            # (reference SemanticsLoader.py:115-118)
            raw = torch.where((raw > 100) | (raw < 0), 100, raw)
        labels = raw[:, 0]
        if "raw" in self.mode:
            sem = raw.float()
        else:
            sem = take_rows(self.embeddings, labels)
        if "inst-areas" in self.mode:
            sem = torch.cat([sem, per_class_area_map(labels, self.embeddings.shape[0])], 1)
        if self.human_sizes is not None:
            sem = torch.cat([sem, take_rows(self.human_sizes, labels)], 1)
        return raw, sem


class InstanceEmbedder:
    """Instance-cue embedding (reference InstanceSegmentationLoader.py:31-121).

    __call__(labels_raw, areas_raw) -> (labels clamped to the table,
    label embeddings (N, 25, H, W), areas (N, 1, H, W) [+ 3 human sizes])."""

    def __init__(self, args, device="cuda"):
        self.mode = args.use_instance_segmentation
        self.embeddings = None
        self.human_sizes = None
        self.background_class = None
        if self.mode is None:
            return
        if self.mode == "raw":
            raise ValueError("Error: raw instance semantics not implemented")
        if self.mode == "coco":
            self.embeddings = _load(
                "coco_81_classes_maskrcnn_ordering_glove_twitter_27b_25d_embeddings.npy", device)
            self.background_class = 0
        elif "ade20k_swin" in self.mode:
            self.embeddings = _load(
                "ade20k_places_classes_glove_twitter_27b_25d_embeddings.npy", device)
            self.background_class = 100
            if "human_sizes" in self.mode:
                self.human_sizes = _load(
                    "ade20k_classes_abs_sizes_shuffled.npy" if "shuffled" in self.mode
                    else "ade20k_classes_abs_sizes.npy", device)
        if self.embeddings is None:
            raise ValueError(f"unknown instance segmentation mode {self.mode!r}")

    def __call__(self, instance_labels_raw, instance_areas_raw):
        if self.mode is None:
            return None, None, None
        raw = instance_labels_raw.to(torch.int32)
        nrows = self.embeddings.shape[0]
        raw = torch.where((raw < 0) | (raw > nrows - 1), self.background_class, raw)
        labels = raw[:, 0]
        emb = take_rows(self.embeddings, labels)
        areas = instance_areas_raw.float()
        if self.human_sizes is not None:
            areas = torch.cat([areas, take_rows(self.human_sizes, labels)], 1)
        return raw, emb, areas
