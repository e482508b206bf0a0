"""Port parity, the parts of data and tensor parallelism that need no
process group (CPU): `parallel.shard_batch_size` against
`mde_tpu.parallel.shard_batch_size` for both batching policies, the loader's
equal shares of an uneven split, the per-rank dropout seeds, the
one-process defaults of `parallel/`, the (data, model) grid's rank map and
groups against the device order of `mde_tpu.parallel.make_mesh`, and the
refusal of a world that is not d·m. The 2-rank steps are
`test_torch_port_ddp.py` and `test_torch_port_tp.py`.
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
    assert parallel.model_group() is None and parallel.grid() == parallel.Grid()
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


def test_grid_orders_ranks_as_jax_orders_devices():
    """On 1,2, 2,2 and 4,2, rank r is where make_mesh("d,m") puts device r:
    data index r // m, model index r % m; its model group is that row of
    the mesh, its data group that column. (One test for the three grids:
    this file stays below `tests/test_train.py`'s eleven tests, so xdist's
    reorder by count queues it after that file.)"""
    import jax

    from mde_tpu.parallel import make_mesh
    from mde_tpu_torch.parallel import Grid

    for shape in ("1,2", "2,2", "4,2"):
        d, m = map(int, shape.split(","))
        mesh = make_mesh(shape, devices=jax.devices()[:d * m])
        assert mesh.axis_names == ("data", "model")
        ids = np.vectorize(lambda device: device.id)(mesh.devices)
        assert sorted(ids.reshape(-1).tolist()) == list(range(d * m))
        for rank in range(d * m):
            g = Grid(d, m, rank)
            assert ids[g.data_index, g.model_index] == rank, shape
            assert g.model_ranks() == ids[g.data_index].tolist(), shape
            assert g.data_ranks() == ids[:, g.model_index].tolist(), shape


def test_a_world_that_is_not_the_grid_raises():
    """d·m must be the world: JAX takes the first d·m devices, and a rank
    outside the grid would hang the port's collectives."""
    from mde_tpu_torch import parallel
    assert parallel.parse_mesh_shape(None, 4) == (4, 1)
    assert parallel.parse_mesh_shape("4", 4) == (4, 1)
    assert parallel.parse_mesh_shape("2,2", 4) == (2, 2)
    with pytest.raises(ValueError, match=r"2 x 2 = 4 ranks, but the world has 2"):
        parallel.parse_mesh_shape("2,2", 2)
    with pytest.raises(ValueError, match=r"8 x 1 = 8 ranks, but the world has 2"):
        parallel.parse_mesh_shape("8", 2)
    args = types.SimpleNamespace(distributed=False, mesh_shape="1,2")
    with pytest.raises(ValueError, match="the world has 1"):
        parallel.maybe_init_distributed(args)
    with pytest.raises(ValueError, match="the world has 3"):
        parallel.init_distributed(0, 3, "tcp://127.0.0.1:1", "gloo", "cpu", "2,2")
    assert not torch.distributed.is_initialized()
