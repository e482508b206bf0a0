"""NYUD2 / KITTI depth dataset and batched loader, the port's own copy of
`mde_tpu/data/dataset.py` (reference dataloader.py:29-620).

Every train sample is exactly (input_height, input_width), every eval sample
the full registered frame. Cue label/area maps stay raw int32; the
embedders (cues/embedders.py) turn them into channels on the device. The
same args and seed give the same samples and batches as the JAX loader:
numpy HWC arrays, collated NHWC; `data/prefetch.py` moves them to the device
as NCHW tensors.

What differs from the JAX loader:
* Files are decoded by the port's own decoders (`data/decode.py`,
  `csrc/mdeaug.cpp`), not PIL, to the same bytes.
* The native engine takes every train batch unless `--no_native_aug` asks
  for the numpy path; a library that fails to build raises instead of
  dropping back to numpy.
* The loader takes `rank` and `world_size` as arguments (default 0 of 1)
  where JAX asks `jax.process_count()`. With several ranks the epoch's
  permutation is cut to a multiple of the world size, each rank takes its
  strided share, and every rank counts the same batches (torch's
  DistributedSampler with drop_last). The JAX loader counts the whole
  split's batches on every process (`mde_tpu/data/dataset.py:311-336`), so a
  process whose share runs out first would be asked for batches it has not
  got; with DDP every rank must take every step.
"""

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from . import transforms as T
from .decode import image_size, read_png, read_rgb
from .native import load_augment_batch


def remove_leading_slash(s: str) -> str:
    if s and s[0] in ("/", "\\"):
        return s[1:]
    return s


def _derive_side_paths(image_path: str, args):
    """Side-file path derivation rules (reference dataloader.py:98-113)."""
    paths = {}
    if args.use_semantics is not None:
        if "ade20k-places" not in args.use_semantics:
            paths["semantics"] = image_path.replace("rgb", "semantic_seg").replace(".jpg", ".npy")
        else:
            paths["semantics"] = image_path.replace(
                "rgb", "instance_labels_ade20k_swin").replace(".jpg", ".npz")
    if args.use_instance_segmentation is not None:
        if "ade20k_swin" in args.use_instance_segmentation:
            paths["instance_labels"] = image_path.replace(
                "rgb", "instance_labels_ade20k_swin").replace(".jpg", ".npz")
            if "bbox" in args.use_instance_segmentation:
                paths["instance_areas"] = image_path.replace(
                    "rgb", "instance_areas_ade20k_swin_bbox").replace(".jpg", ".npz")
            else:
                paths["instance_areas"] = image_path.replace(
                    "rgb", "instance_areas_ade20k_swin").replace(".jpg", ".npz")
        else:
            paths["instance_labels"] = image_path.replace(
                "rgb", "instance_labels_" + args.use_instance_segmentation).replace(".jpg", ".npy")
            paths["instance_areas"] = image_path.replace(
                "rgb", "instance_areas_" + args.use_instance_segmentation).replace(".jpg", ".npy")
    return paths


def _load_label_map(path: str, fallback_shape, fallback_value: int) -> np.ndarray:
    """Load an .npy/.npz int map; npz files with no predictions fall back to a
    constant map (reference dataloader.py:125-152)."""
    if path.endswith(".npz"):
        raw = np.load(path, allow_pickle=True)["arr_0"]
        if raw is None or np.asarray(raw).ndim != 2:
            raw = np.full(fallback_shape, fallback_value, dtype=np.int32)
        return np.asarray(raw)
    return np.load(path)


class DepthDataset:
    """Indexable dataset of dict samples with HWC numpy arrays.

    mode: 'train' | 'online_eval' | 'test' (reference DataLoadPreprocess).
    Randomness is derived from (seed, epoch, index) so any sample is
    reproducible and epoch shuffling is deterministic.
    """

    def __init__(self, args, mode: str, seed: int = 0):
        self.args = args
        self.mode = mode
        self.seed = seed
        self.epoch = 0
        fname = args.filenames_file_eval if mode == "online_eval" else args.filenames_file
        with open(fname, "r") as f:
            self.filenames = [ln for ln in f.read().splitlines() if ln.strip()]

    def __len__(self):
        return len(self.filenames)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _rng(self, idx: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, self.epoch, idx]))

    # -------------------------------------------------- native-path raw loader
    def load_raw_train(self, idx: int):
        """Decode + boundary/kb-crop one train sample without augmentation —
        the input contract of the native engine (data/native.py). Keeps raw
        dtypes (u8 rgb / u16 depth / i32 cues) so the C++ pass does all float
        work once."""
        args = self.args
        parts = self.filenames[idx].split()
        image_path = os.path.join(args.data_path, remove_leading_slash(parts[0]))
        depth_path = os.path.join(args.gt_path, remove_leading_slash(parts[1]))
        side_paths = _derive_side_paths(image_path, args)

        image = read_rgb(image_path)
        depth = read_png(depth_path).astype(np.uint16)
        hw = image.shape[:2]
        out = {"focal": np.float32(float(parts[2]))}
        maps = {}
        if "semantics" in side_paths:
            maps["semantics"] = _load_label_map(side_paths["semantics"], hw, -1).astype(np.int32)
        if "instance_labels" in side_paths:
            maps["instance_labels"] = _load_label_map(
                side_paths["instance_labels"], hw, -1).astype(np.int32)
            maps["instance_areas"] = _load_label_map(
                side_paths["instance_areas"], hw, 0).astype(np.int32)

        if args.do_kb_crop:
            h, w = image.shape[:2]
            top, left = int(h - 352), int((w - 1216) / 2)
            sl = np.s_[top:top + 352, left:left + 1216]
            image, depth = image[sl], depth[sl]
            maps = {k: v[sl] for k, v in maps.items()}
        if args.dataset == "nyu":
            sl = np.s_[45:472, 43:608]
            image, depth = image[sl], depth[sl]
            maps = {k: v[sl] for k, v in maps.items()}

        out["rgb"] = image
        out["depth"] = depth
        out.update(maps)
        return out

    # ------------------------------------------------------------------ train
    def _getitem_train(self, idx: int):
        args = self.args
        rng = self._rng(idx)
        parts = self.filenames[idx].split()
        focal = float(parts[2])

        if args.dataset == "kitti" and getattr(args, "use_right", False) and rng.random() > 0.5:
            image_path = os.path.join(args.data_path, remove_leading_slash(parts[3]))
            depth_path = os.path.join(args.gt_path, remove_leading_slash(parts[4]))
            side_paths = {}
        else:
            image_path = os.path.join(args.data_path, remove_leading_slash(parts[0]))
            depth_path = os.path.join(args.gt_path, remove_leading_slash(parts[1]))
            side_paths = _derive_side_paths(image_path, args)

        image = read_rgb(image_path).astype(np.float32)
        depth = read_png(depth_path).astype(np.float32)
        hw = image.shape[:2]

        maps = {}
        if "semantics" in side_paths:
            maps["semantics"] = _load_label_map(side_paths["semantics"], hw, -1).astype(np.int32)
        if "instance_labels" in side_paths:
            maps["instance_labels"] = _load_label_map(
                side_paths["instance_labels"], hw, -1).astype(np.int32)
            maps["instance_areas"] = _load_label_map(
                side_paths["instance_areas"], hw, 0).astype(np.int32)

        # KITTI benchmark crop (reference dataloader.py:163-174)
        if args.do_kb_crop:
            h, w = image.shape[:2]
            top = int(h - 352)
            left = int((w - 1216) / 2)
            image = image[top:top + 352, left:left + 1216]
            depth = depth[top:top + 352, left:left + 1216]
            maps = {k: v[top:top + 352, left:left + 1216] for k, v in maps.items()}

        # NYU registration-boundary crop (reference dataloader.py:177-184):
        # PIL box (43, 45, 608, 472) == rows 45:472, cols 43:608.
        if args.dataset == "nyu":
            image = image[45:472, 43:608]
            depth = depth[45:472, 43:608]
            maps = {k: v[45:472, 43:608] for k, v in maps.items()}

        # random rotation (reference dataloader.py:186-194)
        if args.do_random_rotate:
            angle = (rng.random() - 0.5) * 2 * args.degree
            # PIL rotates the uint8 image (reference dataloader.py:186-194),
            # re-quantizing bilinear output to integer steps (round half up)
            image = np.floor(T.rotate(image, angle, nearest=False) + 0.5)
            depth = T.rotate(depth, angle, nearest=True)
            maps = {k: T.rotate(v, angle, nearest=True) for k, v in maps.items()}

        image = image / 255.0
        depth = depth[..., None] / (1000.0 if args.dataset == "nyu" else 256.0)
        maps = {k: v[..., None].astype(np.int32) for k, v in maps.items()}

        arrays = [image, depth] + [maps[k] for k in sorted(maps)]
        arrays = T.random_crop(rng, args.input_height, args.input_width, *arrays)
        arrays = T.random_flip(rng, *arrays)
        image, depth = arrays[0], arrays[1]
        for k, v in zip(sorted(maps), arrays[2:]):
            maps[k] = v

        if rng.random() > 0.5:
            image = T.augment_image(rng, image, args.dataset)

        if args.image == "noise":  # reference dataloader.py:361-364
            image = rng.random(image.shape, dtype=np.float32)

        sample = {"image": T.normalize_image(image.astype(np.float32)),
                  "depth": depth.astype(np.float32),
                  "focal": np.float32(focal)}
        sample.update(maps)
        return sample

    # ------------------------------------------------------- eval / test
    def _getitem_eval(self, idx: int):
        args = self.args
        parts = self.filenames[idx].split()
        focal = float(parts[2])
        data_path = args.data_path_eval if self.mode == "online_eval" else args.data_path

        image_path = os.path.join(data_path, remove_leading_slash(parts[0]))
        image = read_rgb(image_path).astype(np.float32) / 255.0
        hw = image.shape[:2]

        maps = {}
        side_paths = _derive_side_paths(image_path, args)
        if "semantics" in side_paths:
            maps["semantics"] = _load_label_map(side_paths["semantics"], hw, -1).astype(np.int32)
        if "instance_labels" in side_paths:
            maps["instance_labels"] = _load_label_map(
                side_paths["instance_labels"], hw, -1).astype(np.int32)
            maps["instance_areas"] = _load_label_map(
                side_paths["instance_areas"], hw, 0).astype(np.int32)

        sample = {"focal": np.float32(focal), "image_path": parts[0]}

        if self.mode == "online_eval":
            gt_path = os.path.join(args.gt_path_eval, remove_leading_slash(parts[1]))
            sample["depth_path"] = parts[1]
            try:
                depth = read_png(gt_path).astype(np.float32)[..., None]
                depth = depth / (1000.0 if args.dataset == "nyu" else 256.0)
                has_valid_depth = True
            except OSError:
                depth = np.zeros((*hw, 1), dtype=np.float32)
                has_valid_depth = False
            sample["has_valid_depth"] = has_valid_depth
        else:
            depth = None

        if args.do_kb_crop:
            h, w = image.shape[:2]
            top = int(h - 352)
            left = int((w - 1216) / 2)
            image = image[top:top + 352, left:left + 1216]
            maps = {k: v[top:top + 352, left:left + 1216] for k, v in maps.items()}
            if depth is not None and sample.get("has_valid_depth", False):
                depth = depth[top:top + 352, left:left + 1216]

        if getattr(args, "image", "rgb") == "noise":
            rng = self._rng(idx)
            image = rng.random(image.shape, dtype=np.float32)

        sample["image"] = T.normalize_image(image.astype(np.float32))
        if depth is not None:
            sample["depth"] = depth.astype(np.float32)
        sample.update({k: v[..., None].astype(np.int32) for k, v in maps.items()})
        return sample

    def __getitem__(self, idx: int):
        if self.mode == "train":
            return self._getitem_train(idx)
        return self._getitem_eval(idx)


class DepthDataLoader:
    """Mode-dispatching loader facade (reference dataloader.py:29-62).

    Iterates batched dict samples (numpy, NHWC); train mode shuffles per
    epoch with a deterministic permutation and drops the ragged tail so
    every train batch has the same shape.
    """

    def __init__(self, args, mode: str, seed: Optional[int] = None, rank: int = 0,
                 world_size: int = 1):
        seed = seed if seed is not None else getattr(args, "seed", 0)
        self.mode = mode
        self.args = args
        self.dataset = DepthDataset(args, mode, seed=seed)
        self.rank, self.world_size = rank, world_size
        if mode == "train":
            # each rank assembles its share of the global batch
            self.batch_size = max(1, args.batch_size // world_size)
            self.drop_last = True
            self.shuffle = True
        else:
            self.batch_size = getattr(args, "eval_batch_size", 1)
            self.drop_last = False
            self.shuffle = False
        self.seed = seed
        self._epoch = 0
        self._first_batch = 0

    def set_epoch(self, epoch: int, first_batch: int = 0):
        """Draw epoch `epoch`'s order and samples; iteration starts at batch
        `first_batch` of it (a resumed run skips the batches it took)."""
        self._epoch = epoch
        self._first_batch = first_batch
        self.dataset.set_epoch(epoch)

    def __len__(self):
        n = len(self.dataset)
        if self.world_size > 1 and self.mode == "train":
            n //= self.world_size
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _order(self, rank: int = 0, world_size: int = 1):
        """Epoch ordering; with several ranks each takes a strided slice of
        the shared permutation cut to a multiple of them (the
        DistributedSampler equivalent: every rank derives the same
        permutation from the shared seed)."""
        n = len(self.dataset)
        if not self.shuffle:
            order = np.arange(n)
        else:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, self._epoch, 0xD5]))
            order = rng.permutation(n)
        if world_size > 1 and self.mode == "train":
            order = order[:n - n % world_size][rank::world_size]
        return order

    def _use_native(self) -> bool:
        """The native engine takes every train batch unless the images are
        noise or --no_native_aug asks for the numpy path."""
        return (self.mode == "train" and getattr(self.args, "image", "rgb") != "noise"
                and not getattr(self.args, "no_native_aug", False))

    def __iter__(self):
        order = self._order(self.rank, self.world_size)
        n = len(self)
        workers = max(1, int(getattr(self.args, "num_threads", 4)))
        native = self._use_native()
        with ThreadPoolExecutor(max_workers=workers) as pool:
            for b in range(self._first_batch, n):
                idxs = order[b * self.batch_size:(b + 1) * self.batch_size]
                if native:
                    yield self._native_batch(pool, idxs)
                else:
                    samples = list(pool.map(self.dataset.__getitem__, idxs))
                    yield collate(samples)

    def _draw_params(self, rng, rect_h, rect_w):
        """Random augmentation parameters with the same rng sequence as the
        numpy path so seeds stay comparable (rng already consumed any
        use_right draw)."""
        args = self.args
        angle = (rng.random() - 0.5) * 2 * args.degree if args.do_random_rotate else 0.0
        crop_x = int(rng.integers(0, rect_w - args.input_width + 1))
        crop_y = int(rng.integers(0, rect_h - args.input_height + 1))
        do_flip = rng.random() > 0.5
        do_augment = rng.random() > 0.5
        gamma = brightness = 1.0
        color = (1.0, 1.0, 1.0)
        if do_augment:
            gamma = rng.uniform(0.9, 1.1)
            brightness = rng.uniform(0.75, 1.25) if args.dataset == "nyu" \
                else rng.uniform(0.9, 1.1)
            color = tuple(rng.uniform(0.9, 1.1, size=3))
        return dict(angle_deg=angle, crop_x=crop_x, crop_y=crop_y,
                    do_flip=do_flip, do_augment=do_augment, gamma=gamma,
                    brightness=brightness, color=color,
                    depth_scale=1e-3 if args.dataset == "nyu" else 1 / 256.0)

    def _native_batch(self, pool, idxs):
        """Fully-native path: the C++ engine (csrc/mdeaug.cpp) reads and
        decodes the jpg/png files and fuses pre-crop + rotate/crop/flip/
        jitter/normalize, one thread per sample. Python only parses the split
        line, reads image headers for crop bounds, and loads npy/npz cue maps."""
        args = self.args
        ds = self.dataset

        def prep(idx):
            parts = ds.filenames[idx].split()
            rng = ds._rng(idx)
            use_right = (args.dataset == "kitti" and getattr(args, "use_right", False)
                         and rng.random() > 0.5)
            if use_right:
                rgb_path = os.path.join(args.data_path, remove_leading_slash(parts[3]))
                depth_path = os.path.join(args.gt_path, remove_leading_slash(parts[4]))
            else:
                rgb_path = os.path.join(args.data_path, remove_leading_slash(parts[0]))
                depth_path = os.path.join(args.gt_path, remove_leading_slash(parts[1]))
            w, h = image_size(rgb_path)  # header-only read
            if args.do_kb_crop:
                rect = (int((w - 1216) / 2), int(h - 352), 1216, 352)
            elif args.dataset == "nyu":
                rect = (43, 45, 565, 427)
            else:
                rect = None
            rect_h = rect[3] if rect else h
            rect_w = rect[2] if rect else w
            cues = {}
            if not use_right:
                side_paths = _derive_side_paths(rgb_path, args)
                for key, fallback in (("semantics", -1), ("instance_labels", -1),
                                      ("instance_areas", 0)):
                    if key in side_paths:
                        cues[key] = _load_label_map(side_paths[key], (h, w), fallback)
            return (rgb_path, depth_path, cues, rect,
                    self._draw_params(rng, rect_h, rect_w), np.float32(parts[2]))

        rows = list(pool.map(prep, idxs))
        rgb_paths, depth_paths, cue_maps, rects, params, focals = zip(*rows)
        out = load_augment_batch(
            list(rgb_paths), list(depth_paths), list(cue_maps), list(rects),
            args.input_height, args.input_width, list(params),
            num_threads=int(getattr(args, "num_threads", 0)))
        batch = {"image": out["image"], "depth": out["depth"],
                 "focal": np.asarray(focals, np.float32)}
        for k in ("semantics", "instance_labels", "instance_areas"):
            if out.get(k) is not None:
                batch[k] = out[k]
        return batch


def collate(samples):
    """Stack a list of sample dicts into a batch dict of NHWC arrays."""
    batch = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], (str,)):
            batch[key] = vals
        elif np.isscalar(vals[0]) or np.asarray(vals[0]).ndim == 0:
            batch[key] = np.asarray(vals)
        else:
            batch[key] = np.stack(vals, axis=0)
    return batch
