"""Port parity, the parts of data parallelism that need no process group
(CPU): `parallel.shard_batch_size` against `mde_tpu.parallel.shard_batch_size`
for both batching policies, the loader's equal shares of an uneven split,
the per-rank dropout seeds, and the one-process defaults of `parallel/`.
The 2-rank steps are `test_torch_port_ddp.py`.
"""

import types

import numpy as np
import pytest
import torch


def test_dropout_seeds_differ_per_rank():
    """(seed, step, micro, rank) with several ranks; one process keeps
    (seed, step, micro)."""
    from mde_tpu_torch.train.loop import _dropout_seed
    seeds = {_dropout_seed(42, 3, 0, r) for r in range(4)}
    assert len(seeds) == 4
    assert _dropout_seed(42, 3, 0) == int(
        np.random.SeedSequence([42, 3, 0]).generate_state(1)[0])


@pytest.mark.parametrize("bs,n", [(16, 2), (9, 2), (1, 4), (16, 8)])
def test_shard_batch_size_matches_jax(bs, n):
    """Both batching policies: legacy (bs global, rounded down to a multiple
    of the ranks) and use_new_batching (bs a rank)."""
    import jax

    from mde_tpu.parallel import make_mesh, shard_batch_size as jax_shard_batch_size
    from mde_tpu_torch.parallel import shard_batch_size

    mesh = make_mesh(str(n), devices=jax.devices()[:n])
    for use_new_batching in (False, True):
        assert shard_batch_size(bs, n, use_new_batching) == jax_shard_batch_size(
            bs, mesh, use_new_batching), use_new_batching


def test_single_process_has_no_sync_group():
    from mde_tpu_torch import parallel
    assert parallel.world() == (0, 1)
    assert parallel.sync_group() is None
    t = torch.ones(3, requires_grad=True)
    assert parallel.all_reduce_sum(t) is t
    assert parallel.maybe_init_distributed(types.SimpleNamespace(distributed=False)) == (0, 1)


@pytest.mark.parametrize("n_frames", [5, 6])
def test_ranks_take_equal_shares_of_an_uneven_split(tmp_path, n_frames):
    """Under DDP every rank takes every step: the permutation is cut to a
    multiple of the world size, each rank takes its strided share, and the
    ranks count the same batches."""
    from mde_tpu_torch.data import DepthDataLoader
    (tmp_path / "train.txt").write_text("".join(f"/a/rgb_{i}.jpg /a/d_{i}.png 518.8579\n"
                                                for i in range(n_frames)))
    args = types.SimpleNamespace(filenames_file=str(tmp_path / "train.txt"), batch_size=2,
                                 seed=3)
    whole = DepthDataLoader(args, "train")._order()
    ranks = [DepthDataLoader(args, "train", rank=r, world_size=2) for r in (0, 1)]
    orders = [r._order(r.rank, r.world_size) for r in ranks]
    assert [len(o) for o in orders] == [n_frames // 2] * 2
    assert np.array_equal(orders[0], whole[:n_frames // 2 * 2][0::2])
    assert np.array_equal(orders[1], whole[:n_frames // 2 * 2][1::2])
    assert [len(r) for r in ranks] == [n_frames // 2] * 2  # one image a rank a step
