"""Tensor parallelism (the ``tp`` route) against the JAX package on the CPU:
the port's parameter split pinned to the JAX ``_tp_spec_for`` for every leaf
of the dinov2-small net and of the ViT-L-dims net of the JAX TP tests; the
(data, model) grid of ``make_groups`` against ``make_mesh``; one train step
at TP = 2 and at DP x TP = 2 x 2 on gloo ranks of one pool (spawned once for
the module, free of JAX) against the JAX single-device ``make_train_step``
at the JAX TP tests' dims, with the JAX TP tolerances; the replicated
gradients bit-equal across model ranks; and what the route refuses."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_rank_workers as workers
from crossscore_tpu.confsys import load_config as jax_load_config
from crossscore_tpu.models import CrossScoreConfig as JaxConfig
from crossscore_tpu.models import CrossScoreNet as JaxNet
from crossscore_tpu.models import ViTConfig as JaxViT
from crossscore_tpu.parallel import make_mesh
from crossscore_tpu.parallel.mesh import _tp_spec_for
from crossscore_tpu.train import create_train_state
from crossscore_tpu.train import make_optimizer as jax_make_optimizer
from crossscore_tpu.train import make_train_step as jax_make_train_step
from crossscore_tpu_torch.io.convert import state_dict_from_jax
from crossscore_tpu_torch.models import VIT_PRESETS, CrossScoreConfig
from crossscore_tpu_torch.parallel.launch import RankPool
from crossscore_tpu_torch.parallel.tensor_parallel import COLUMN, ROW, tp_spec_for

# the JAX TP tests' dims (tests/test_parallel.py MCFG) and tolerances
JVIT = JaxViT(hidden_size=64, num_layers=2, num_heads=4, patch_size=14, image_size=56)
MCFG = JaxConfig(backbone=JVIT, pe_h=6, pe_w=6, decoder_heads=4)
LOSS_RTOL, PARAM_ATOL = 2e-5, 2e-5


@pytest.fixture(scope="module")
def pool():
    # one intra-op thread per rank: the ranks' work is small, and the test
    # run's other workers share the cores
    with RankPool(4, env={"OMP_NUM_THREADS": "1"}) as p:
        yield p


def _batch(seed, b, hw=56, k=2):
    rng = np.random.default_rng(seed)
    return {"query/img": rng.standard_normal((b, hw, hw, 3)).astype(np.float32),
            "reference/cross/imgs": rng.standard_normal((b, k, hw, hw, 3)).astype(np.float32),
            "query/score_map": rng.random((b, hw, hw)).astype(np.float32)}


# --- the split of every parameter ------------------------------------------------------------


def _specs(jcfg):
    """Each port key -> (its spec, the JAX specs of the leaves it comes from):
    every JAX leaf is filled with its own index, carried across by
    ``state_dict_from_jax`` and read back."""
    b = _batch(0, 1)
    shapes = jax.eval_shape(JaxNet(jcfg).init, jax.random.PRNGKey(0), jnp.asarray(b["query/img"]),
                            jnp.asarray(b["reference/cross/imgs"]))["params"]
    leaves, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    filled = jax.tree_util.tree_unflatten(treedef, [np.full(x.shape, i + 1, np.float32)
                                                    for i, (_, x) in enumerate(leaves)])
    jspec = {i + 1: (tuple(p.key for p in path), _tp_spec_for(tuple(p.key for p in path), x))
             for i, (path, x) in enumerate(leaves)}
    out = {}
    for key, val in state_dict_from_jax(filled).items():
        ids = np.unique(np.asarray(val).reshape(np.asarray(val).shape[0] if np.ndim(val) else 1, -1)[:, 0])
        if ids.size == 1 and ids[0] == 0:  # mask_token: no JAX leaf
            continue
        if key != "model.img_mean_std":
            out[key] = (tp_spec_for(key), [jspec[int(i)] for i in ids])
    return out


JAX_TO_PORT = {jax.sharding.PartitionSpec(None, "model"): COLUMN,
               jax.sharding.PartitionSpec("model", None): ROW, jax.sharding.PartitionSpec(): None}


@pytest.mark.parametrize("dims", ["dinov2-small", "vit-l"])
def test_tp_spec_matches_jax_for_every_leaf(dims):
    """Weights take the JAX kernel's spec; a bias follows its layer when that
    is column-parallel (JAX keeps it whole, GSPMD slices it) and stays whole
    otherwise, as every JAX bias does."""
    if dims == "dinov2-small":
        jcfg = JaxConfig()
    else:  # the ViT-L head geometry of the JAX TP tests
        jcfg = JaxConfig(backbone=JaxViT(hidden_size=1024, num_layers=2, num_heads=16, patch_size=14,
                                         image_size=56), pe_h=6, pe_w=6, decoder_heads=8)
    seen = 0
    for key, (spec, sources) in _specs(jcfg).items():
        kinds = {path[-1] for path, _ in sources}
        want = {JAX_TO_PORT[s] for _, s in sources}
        assert len(want) == 1, (key, sources)  # the q/k/v kernels packed into one tensor agree
        want = want.pop()
        if kinds == {"bias"}:
            assert want is None, key  # JAX replicates every bias
            kernel = key[:-len("bias")] + "weight"  # .bias -> .weight, in_proj_bias -> in_proj_weight
            want = COLUMN if tp_spec_for(kernel) == COLUMN else None
        assert spec == want, (key, spec, want)
        seen += 1
    assert seen > 40


# --- the grid -------------------------------------------------------------------------------


@pytest.mark.parametrize("n,mp,batch", [(4, 2, None), (4, 2, 3), (4, 1, 2), (4, 4, 8), (2, 2, None),
                                        (4, 3, None), (4, 8, None)])
def test_make_groups_matches_make_mesh(pool, n, mp, batch):
    """The grid's shape is the JAX mesh's on as many devices; rank r sits at
    (r // mp, r % mp); the checks that raise there raise here."""
    got = pool.run(workers.make_groups_grid, n, mp, batch, timeout=120)
    try:
        shape = make_mesh(n, model_parallel=mp, batch_size=batch).devices.shape
    except ValueError as e:
        assert all(r[0] == "raised" for r in got), got
        assert ("exceeds" in str(e)) == ("exceeds" in got[0][1])
        return
    dp = shape[0]
    assert len(shape) == (2 if mp > 1 else 1) and (shape[1] if mp > 1 else 1) == mp
    for rank, r in enumerate(got):
        assert r[:2] == (dp, mp)
        if rank >= dp * mp:
            assert r[2:] == (None,) * 4
            continue
        d, m = divmod(rank, mp)
        assert r[2:] == (d, m, [d * mp + j for j in range(mp)], [i * mp + m for i in range(dp)])


# --- one train step ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_step():
    """The JAX single-device step at the TP tests' dims: params, batch, the
    loss and the updated params (as reference Lightning state dicts)."""
    batch = _batch(3, 4)
    params = jax.device_get(jax.jit(JaxNet(MCFG).init)(jax.random.PRNGKey(0), jnp.asarray(batch["query/img"][:1]),
                                                       jnp.asarray(batch["reference/cross/imgs"][:1]))["params"])
    tx, _ = jax_make_optimizer(jax_load_config("default"), params, steps_per_epoch=10)
    state, metrics = jax.jit(jax_make_train_step(JaxNet(MCFG), tx))(
        create_train_state(params, tx), {k: jnp.asarray(v) for k, v in batch.items()})
    return (state_dict_from_jax(params), batch, float(metrics["loss"]),
            state_dict_from_jax(jax.device_get(state.params)))


def _port_cfg(mlp_impl):
    return CrossScoreConfig(backbone=VIT_PRESETS["dinov2-test"], pe_h=6, pe_w=6, decoder_heads=4,
                            compute_dtype=torch.float32, attention_impl="tp", mlp_impl=mlp_impl)


@pytest.mark.parametrize("n,mp,mlp_impl", [(2, 2, "unfused"), (4, 2, "unfused"), (2, 2, "fused_exact")],
                         ids=["tp2", "dp2xtp2", "tp2-whole-k2"])
def test_tp_train_step_matches_jax(pool, jax_step, n, mp, mlp_impl):
    """Loss (rtol 2e-5) and every parameter after one AdamW step (atol 2e-5)
    against the JAX single-device step; the backbone bit-identical; the
    initial weights' shard/gather round trip exact; the replicated
    parameters' gradients bit-equal on the ranks of each model group."""
    init, batch, loss, want = jax_step
    got = pool.run(workers.tp_train_step, n, mp, _port_cfg(mlp_impl), init, batch, [], timeout=300)
    active = [r for r in got if r is not None]
    assert len(active) == n and all(r["round_trip"] for r in active)
    assert active[0]["n_local"] < sum(np.asarray(v).size for v in init.values())  # shards, not copies
    for r in active:
        assert r["loss"] == pytest.approx(loss, rel=LOSS_RTOL)
        for key, val in r["params"].items():
            full = f"model.{key}"
            if key.startswith("backbone.") or key == "pos_enc_fn.PE":
                np.testing.assert_array_equal(val, init[full], err_msg=key)
            else:
                np.testing.assert_allclose(val, want[full], atol=PARAM_ATOL, rtol=0, err_msg=key)
    by_group = {}
    for r in active:
        by_group.setdefault(r["grid"][0], []).append(r["replicated_grads"])
    for grads in by_group.values():
        assert len(grads) == mp and len(grads[0]) >= 10  # LayerNorms, row-parallel biases
        for other in grads[1:]:
            for name, g in grads[0].items():
                np.testing.assert_array_equal(other[name], g, err_msg=name)


# --- what the route refuses -------------------------------------------------------------------


def test_tp_refusals(pool):
    got = pool.run(workers.tp_refusals, _port_cfg("unfused"), timeout=120)
    for r in got[:2]:
        assert r["no groups"].startswith("RuntimeError: no model group"), r
        assert r["heads"] == "ValueError: 3 heads not divisible by the model group's 2 ranks", r
        assert r["buckets"].startswith("NotImplementedError: shape-bucketed masking under the tp"), r


@pytest.mark.parametrize("task", ["train", "predict"])
def test_clis_refuse_tp(task):
    """No task CLI builds a model group, as no JAX CLI builds a model axis."""
    from crossscore_tpu_torch.tasks import predict, train

    main = train.main if task == "train" else predict.main
    with pytest.raises(NotImplementedError, match="attention_impl=tp"):
        main(["trainer.accelerator=cpu", "model.gpu.attention_impl=tp"])
