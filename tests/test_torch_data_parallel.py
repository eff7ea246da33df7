"""The parts of the port's data parallelism on the CPU: the loader's node
shards and rank blocks against the JAX ``Loader`` (index lists, ``_valid``
and batches), ``prepare_global_shard`` against JAX's (and the row-count case
where the two differ), the data layout against ``make_mesh``'s data axis
with nodes for processes, ``all_process_weighted_mean`` over 2 and 3 gloo
ranks, a shared token store under two writers, the refusals that remain,
and ``tools.dryrun_multichip`` on 4 and 3 ranks. One pool of 4 ranks for
the module, laid out as 2 nodes x 2."""

import jax
import numpy as np
import pytest

import torch_rank_workers as workers
from crossscore_tpu.data import fastimage as jax_fastimage
from crossscore_tpu.data.bucketing import ShapeBucketedLoader as JaxBucketedLoader
from crossscore_tpu.data.loader import Loader as JaxLoader
from crossscore_tpu.data.loader import prepare_global_shard as jax_prepare_global_shard
from crossscore_tpu.data.nvs_index import get_dataset as jax_get_dataset
from crossscore_tpu.confsys import load_config as jax_load_config
from crossscore_tpu.parallel import make_mesh
from crossscore_tpu_torch.confsys import load_config
from crossscore_tpu_torch.data import fastimage as port_fastimage
from crossscore_tpu_torch.data.bucketing import ShapeBucketedLoader
from crossscore_tpu_torch.data.loader import Loader, prepare_global_shard, rank_block
from crossscore_tpu_torch.data.nvs_index import get_dataset
from crossscore_tpu_torch.data.synthetic import generate
from crossscore_tpu_torch.parallel import mesh
from crossscore_tpu_torch.parallel.launch import RankPool
from crossscore_tpu_torch.tasks.common import all_process_weighted_mean, refuse_multi_rank
from crossscore_tpu_torch.tools import dryrun_multichip


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, env={"OMP_NUM_THREADS": "1"}, local_world_size=2) as p:
        yield p


class _Sized:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


# --- the loader's node shards and rank blocks ------------------------------------------------------

GRID = [(n, shards, bs) for n in (1, 3, 7, 10, 16) for shards in (1, 2, 3, 4, 8) for bs in (1, 2, 4)]


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("n,shards,bs", GRID)
def test_node_plan_equals_jax_shards(n, shards, bs, shuffle):
    """Every shard's index list, its non-duplicate count and its batch plan
    (chunks and ``_valid``) are JAX's, bit for bit, n < shards included."""
    for shard in range(shards):
        kw = dict(batch_size=bs, shuffle=shuffle, seed=5, shard_index=shard, num_shards=shards)
        got, want = Loader(_Sized(n), **kw), JaxLoader(_Sized(n), **kw)
        for epoch in (0, 1):
            (gi, gn), (wi, wn) = got._epoch_indices(epoch), want._epoch_indices(epoch)
            np.testing.assert_array_equal(gi, wi)
            assert gn == wn
            gp, wp = got._node_plan(epoch), want._plan(epoch)
            assert len(gp) == len(wp)
            for (gc, gv, _), (wc, wv, _) in zip(gp, wp):
                np.testing.assert_array_equal(gc, wc)
                assert gv == wv


@pytest.mark.parametrize("n,shards,bs", [g for g in GRID if g[2] > 1])
def test_rank_blocks_cut_the_node_batch(n, shards, bs):
    """Each node batch, padded to ``bs`` rows as the loader pads it, is the
    concatenation of its ranks' blocks, and each rank's ``_valid`` is JAX's
    ``prepare_global_shard`` mask of the node batch cut to the rank."""
    for d in [x for x in (2, 4) if bs % x == 0]:
        for shard in range(shards):
            node = JaxLoader(_Sized(n), batch_size=bs, shuffle=False, shard_index=shard, num_shards=shards)
            ranks = [Loader(_Sized(n), batch_size=bs, shuffle=False, shard_index=shard, num_shards=shards,
                            rank_index=r, rank_count=d) for r in range(d)]
            plans = [rl._plan(0) for rl in ranks]
            for b, (chunk, n_valid, _) in enumerate(node._plan(0)):
                padded = np.concatenate([chunk, np.repeat(chunk[-1:], bs - len(chunk))])
                mask = jax_prepare_global_shard({"query/img": np.zeros((bs, 1)), "_valid": n_valid}, bs)["_valid_mask"]
                rows = []
                for r, plan in enumerate(plans):
                    rc, rv, _ = plan[b]
                    block = np.concatenate([rc, np.repeat(rc[-1:], bs // d - len(rc))])
                    rows.append(block)
                    assert rv == int(mask[r * bs // d:(r + 1) * bs // d].sum())
                np.testing.assert_array_equal(np.concatenate(rows), padded)


def test_rank_block_rules():
    assert rank_block(np.arange(3), 3, 4, 1, 2) == (pytest.approx(np.asarray([2])), 1)
    rows, valid = rank_block(np.arange(3), 3, 8, 3, 4)  # an all-padding block: the last index alone
    np.testing.assert_array_equal(rows, [2])
    assert valid == 0
    with pytest.raises(ValueError, match="equal block"):
        Loader(_Sized(4), batch_size=3, rank_index=0, rank_count=2)
    with pytest.raises(ValueError, match="pad_last or drop_last"):
        Loader(_Sized(4), batch_size=4, rank_index=0, rank_count=2, pad_last=False)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_fastimage, "available", lambda: False)
    mp.setattr(port_fastimage, "available", lambda: False)
    root = tmp_path_factory.mktemp("dp_tree")
    generate(root / "datadir", hw=(84, 112), scenes_per_split={"train": 1, "test": 1})
    generate(root / "mixed", hw=[(84, 112), (112, 84)], scenes_per_split={"train": 1, "test": 2})
    yield root
    mp.undo()


def _datasets(root, tree_name, split="train", **kw):
    ov = ["model.backbone.preset=dinov2-test", "data.neighbour_config.cross=2",
          f"data.dataset.path=[{root / tree_name}]", "data.transforms.crop_size=56", "this_main.resize_short_side=-1"]
    return (get_dataset(load_config("default", ov), split, **kw),
            jax_get_dataset(jax_load_config("default", ov), split, **kw))


def _concat(batches: list) -> dict:
    return {k: np.concatenate([b[k] for b in batches]) for k in ("query/img", "reference/cross/imgs",
                                                                 "query/score_map")}


@pytest.mark.parametrize("shards", [1, 2])
def test_rank_batches_concatenate_to_the_jax_batches(tree, shards):
    """On the synthetic tree (7 train items, shuffled, B=4): each node's
    ranks' batches, concatenated, are the JAX loader's batches of that
    shard, pixel for pixel (the per-item crop stream does not depend on the
    rank that decodes the item); each rank's ``_valid`` and ``_valid_mask``
    are its block of JAX's."""
    ds_t, ds_j = _datasets(tree, "datadir")
    for shard in range(shards):
        kw = dict(batch_size=4, shuffle=True, seed=3, num_workers=1, shard_index=shard, num_shards=shards)
        want = list(JaxLoader(ds_j, **kw).epoch(1))
        got = [list(Loader(ds_t, rank_index=r, rank_count=2, **kw).epoch(1)) for r in range(2)]
        assert len(want) == len(got[0]) == len(got[1])
        for b, wb in enumerate(want):
            parts = [got[r][b] for r in range(2)]
            for key, value in _concat(parts).items():
                np.testing.assert_array_equal(value, wb[key], err_msg=key)
            mask = jax_prepare_global_shard(wb, 4)["_valid_mask"]
            for r, p in enumerate(parts):
                np.testing.assert_array_equal(p["_valid_mask"], mask[2 * r:2 * r + 2])
                assert int(p["_valid"]) == int(mask[2 * r:2 * r + 2].sum())


def test_bucketed_loader_shards_each_bucket(tree):
    """The mixed-aspect tree's test split (two shapes, one bucket each at
    multiple 56): on one node the plan is JAX's; over 2 nodes each bucket's
    items are split with wrap-around, every node steps through the same
    buckets the same number of times, and the valid items cover each item
    once (JAX's bucketed loader ignores its shard arguments)."""
    ds_t, ds_j = _datasets(tree, "mixed", "test", crop_mode="integer_patches", return_item_paths=True,
                           deterministic_crop=True)
    one, jax_one = ShapeBucketedLoader(ds_t, batch_size=2, bucket_multiple=56), \
        JaxBucketedLoader(ds_j, batch_size=2, bucket_multiple=56)
    assert [(list(c), v, e) for c, v, e in one._plan(0)] == [(list(c), v, e) for c, v, e in jax_one._plan(0)]
    plans = [ShapeBucketedLoader(ds_t, batch_size=2, bucket_multiple=56, shard_index=s, num_shards=2)._plan(0)
             for s in range(2)]
    assert [e["bucket"] for _, _, e in plans[0]] == [e["bucket"] for _, _, e in plans[1]]
    seen = [int(i) for plan in plans for c, v, _ in plan for i in c[:v]]
    assert sorted(seen) == list(range(len(ds_t)))


# --- prepare_global_shard -------------------------------------------------------------------------


def _shard_cases():
    yield {"query/img": np.zeros((4, 8, 8, 3), np.float32), "_valid": np.asarray(3, np.int32),
           "_valid_hw": np.asarray([6, 8], np.int32)}, 4
    yield {"query/img": np.zeros((3, 8, 8, 3), np.float32), "_valid": np.asarray(3, np.int32),
           "_valid_hw": np.asarray([6, 8], np.int32)}, 4  # a short batch: the actual rows
    yield {"x": np.zeros(3)}, 4  # no _valid: passes through


@pytest.mark.parametrize("case", range(3))
def test_prepare_global_shard_equals_jax_on_its_cases(case):
    batch, bs = list(_shard_cases())[case]
    got, want = prepare_global_shard(batch, bs), jax_prepare_global_shard(batch, bs)
    assert set(got) == set(want)
    for key in want:
        if key == "_valid":
            assert isinstance(got[key], int) and got[key] == want[key]
        else:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_prepare_global_shard_row_count_deviation():
    """The row count comes from the batch's images, not from whichever array
    comes first: with a shared (2,) ``_valid_hw`` ahead of 4 images, JAX's
    copy makes a 2-row mask and a (2, 2) ``_valid_hw``; the port's makes 4
    rows (ROADMAP, Known deviations)."""
    batch = {"_valid_hw": np.asarray([6, 8], np.int32), "query/img": np.zeros((4, 8, 8, 3), np.float32),
             "_valid": np.asarray(3, np.int32)}
    want, got = jax_prepare_global_shard(batch, 4), prepare_global_shard(batch, 4)
    assert want["_valid_mask"].shape == (2,) and want["_valid_hw"].shape == (2, 2)
    np.testing.assert_array_equal(got["_valid_mask"], [1, 1, 1, 0])
    assert got["_valid_hw"].shape == (4, 2)
    tokens = {"_valid_hw": np.asarray([6, 8]), "query/tokens": np.zeros((3, 4, 8)), "_valid": 2}
    np.testing.assert_array_equal(prepare_global_shard(tokens, 8)["_valid_mask"], [1, 1, 0])


# --- the data layout ---------------------------------------------------------------------------------


@pytest.mark.parametrize("n_proc,batch,mp", [(2, 2, 1), (2, 3, 1), (2, 4, 1), (2, 8, 1), (4, 2, 1), (4, 1, 1),
                                            (2, 2, 2), (2, 1, 2), (1, 3, 1), (1, 6, 2), (8, 5, 1)])
def test_layout_equals_make_mesh_with_nodes_for_processes(monkeypatch, n_proc, batch, mp):
    """8 ranks as ``n_proc`` nodes keep the ranks whose numbers are the
    devices the JAX mesh keeps over as many processes (the multi-host matrix
    of tests/test_parallel.py), in the mesh's order."""
    monkeypatch.setattr(jax, "process_count", lambda: n_proc)
    want = [d.id for d in make_mesh(model_parallel=mp, batch_size=batch).devices.reshape(-1)]
    got = mesh.grid_members(8, [8 // n_proc] * 8, mp, batch)
    assert got == want


def test_layout_raises_where_make_mesh_raises(monkeypatch):
    monkeypatch.setattr(jax, "process_count", lambda: 4)
    with pytest.raises(ValueError, match="below the"):
        make_mesh(2, batch_size=8)
    with pytest.raises(ValueError, match="below the 4 nodes"):
        mesh.grid_members(8, [2] * 8, 1, 8, n_ranks=2)
    with pytest.raises(ValueError, match="exceeds"):
        mesh.grid_members(4, [4] * 4, 8, 16)
    with pytest.raises(ValueError, match="unequal numbers of ranks"):
        mesh.grid_members(4, [2, 2, 2, 1], 1, 2)


def test_devices_count_launched_ranks():
    assert mesh.requested_ranks(-1, 4) == 4 and mesh.requested_ranks(None, 2) == 2
    assert mesh.requested_ranks(2, 4) == 2 and mesh.requested_ranks([0, 1, 2], 4) == 3
    with pytest.raises(ValueError, match=r"asks for 5 ranks, and 4 were launched.*torchrun --nproc_per_node 5"):
        mesh.requested_ranks(5, 4)


def test_layout_over_two_nodes_of_two(pool):
    """The pool's 4 ranks as 2 nodes x 2: B=2 keeps both ranks of each node
    (one data group of 4); B=1 keeps each node's first rank (ranks 1 and 3
    left out); trainer.devices=2 caps it at one rank a node; nodes that
    launched unequal rank counts raise on every rank."""
    assert pool.run(workers.data_layout, 2, None) == [(4, r, [0, 1, 2, 3]) for r in range(4)]
    assert pool.run(workers.data_layout, 1, None) == [(2, 0, [0, 2]), (2, None, None), (2, 1, [0, 2]),
                                                      (2, None, None)]
    assert pool.run(workers.data_layout, 2, 2) == [(2, 0, [0, 2]), (2, None, None), (2, 1, [0, 2]),
                                                   (2, None, None)]
    uneven = pool.run(workers.data_layout, 2, None, [2, 2, 1, 1])
    assert all(r[0] == "raised" and "unequal numbers of ranks" in r[1] for r in uneven)


@pytest.mark.parametrize("n_active", [2, 3])
def test_weighted_mean_over_ranks_equals_one_process(pool, n_active):
    rng = np.random.default_rng(n_active)
    series = [[rng.random(5).tolist(), rng.random(5).tolist()] for _ in range(4)]
    weights = [rng.integers(0, 4, 5).tolist() for _ in range(4)]
    got = pool.run(workers.weighted_mean, n_active, series, weights)
    want = all_process_weighted_mean(
        [sum((series[r][i] for r in range(n_active)), []) for i in range(2)],
        sum((weights[r] for r in range(n_active)), []))
    for r in range(4):
        if r >= n_active:
            assert got[r] is None
        else:
            np.testing.assert_allclose(got[r], want, rtol=1e-12)


def test_shared_token_store_under_two_writers(pool, tmp_path):
    """4 ranks write one key of one store 20 times each, released together:
    one whole file stays, no temporary one."""
    names = pool.run(workers.store_one_key, str(tmp_path), 20)
    assert len(names[0]) == 1 and all(n == names[0] for n in names) and ".tmp." not in names[0][0]
    with np.load(tmp_path / names[0][0]) as z:
        assert tuple(z["shape"]) == (16, 64) and z["data"].size == 16 * 64 * 4


def test_serve_refuses_several_ranks(monkeypatch):
    """The daemon stays one process over its local devices, as the JAX
    daemon is: a launch of several ranks, or trainer.devices above 1,
    raises."""
    cfg = load_config("default_predict")
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    refuse_multi_rank(cfg)  # -1 and 1 pass
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="WORLD_SIZE=2: the serve daemon runs one process"):
        refuse_multi_rank(cfg)
    monkeypatch.delenv("WORLD_SIZE")
    with pytest.raises(NotImplementedError, match="trainer.devices=2"):
        refuse_multi_rank(load_config("default_predict", ["trainer.devices=2"]))


# --- the dry run --------------------------------------------------------------------------------------


@pytest.mark.parametrize("n", [4, 3])
def test_dryrun_multichip_on_cpu_ranks(n, capsys):
    """As tests/test_parallel.py runs JAX's: 4 ranks take model_parallel 2,
    3 (odd) take 1; every phase's check holds."""
    assert dryrun_multichip.main([str(n), "--cpu"]) == 0
    out = capsys.readouterr().out
    assert f"grid (data, model) = {(n // 2, 2) if n == 4 else (n, 1)}" in out
    assert f"dryrun_multichip OK ({n} ranks" in out
