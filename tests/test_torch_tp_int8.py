"""The int8 W8A8 backbone under tensor parallelism (``attention_impl="tp"`` with
``backbone_quant="int8"``) against the JAX package's ``tp:model`` int8 step
and the port's one-rank int8 net on the CPU: the split forms of the row
quantisation and the product (Q1a, Q1b and Q2's int32 form, by their plain
versions) against Q1, JAX's eager quantisers and ``torch._int_mm``; the int8
column and row layers on 2 gloo ranks bit-equal to the one-rank linear, and
a row layer whose MAX all-reduce is left out caught; one train step and one
predict forward at TP = 2 and DP x TP = 2 x 2 against JAX's jitted step on
``make_mesh(8, model_parallel=2)`` and against the port's one-rank int8 net.

The ranks come from one ``RankPool`` for the module (free of JAX); inputs
from numpy seeds; weights cross by ``state_dict_from_jax``."""

import dataclasses

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
from crossscore_tpu.ops.quant import QuantDense, quantize_colwise
from crossscore_tpu.ops.quant import quantize_rowwise as jax_quantize_rowwise
from crossscore_tpu.parallel import make_mesh, param_shardings, shard_batch
from crossscore_tpu.train import create_train_state
from crossscore_tpu.train import make_optimizer as jax_make_optimizer
from crossscore_tpu.train import make_train_step as jax_make_train_step
from crossscore_tpu.train.step import make_predict_step as jax_make_predict_step
from crossscore_tpu_torch.confsys import load_config
from crossscore_tpu_torch.io.convert import load_into, state_dict_from_jax
from crossscore_tpu_torch.models import VIT_PRESETS, CrossScoreConfig, CrossScoreNet
from crossscore_tpu_torch.ops import quant
from crossscore_tpu_torch.parallel.launch import RankPool
from crossscore_tpu_torch.train.optim import make_optimizer
from crossscore_tpu_torch.train.step import TrainState, make_predict_step, make_train_step

# the JAX TP tests' dims (tests/test_parallel.py MCFG), quantised
JVIT = JaxViT(hidden_size=64, num_layers=2, num_heads=4, patch_size=14, image_size=56)
MCFG = JaxConfig(backbone=JVIT, pe_h=6, pe_w=6, decoder_heads=4, backbone_quant="int8")
# score maps of the port's tp int8 net against JAX's jitted tp:model int8
# step: tests/test_torch_int8.py's bounds for the one-rank net against JAX's
# (jitted JAX multiplies by fl(1/127) where the port divides, which moves
# some scales by an ulp and flips the codes at a rounding boundary)
NET_MAE, NET_MAX = 1e-4, 2.5e-3
# the loss and every parameter after one AdamW step: the JAX TP tests'
LOSS_RTOL, PARAM_ATOL = 2e-5, 2e-5
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, env={"OMP_NUM_THREADS": "1"}) as p:
        yield p


def _rows(seed: int = 0) -> np.ndarray:
    """(8, 64) fp32 rows whose absmax sits in one half or the other, a zero
    row (the eps scale), a row of exact ties at s = 1, an outlier row and a
    row of tiny values."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((8, 64)).astype(np.float32)
    x[0, 40] = 9.0  # the absmax in the second half
    x[1] = 0.0
    x[2] = np.resize(np.array([127.0, 2.5, -2.5, 3.5, -3.5, 0.5, -0.5, 1.5, -1.5, 126.5], np.float32), 64)
    x[3, 5] = 1000.0
    x[4] *= 1e-9
    return x


def _ulps(got: torch.Tensor, want: torch.Tensor) -> int:
    bits, mask = (torch.int16, 0x7FFF) if got.dtype == torch.bfloat16 else (torch.int32, 0x7FFFFFFF)
    a, b = (t.contiguous().view(bits).long() for t in (got, want))
    a, b = (torch.where(v < 0, -(v & mask), v) for v in (a, b))
    return int((a - b).abs().max())


# --- the split forms (plain versions on the CPU) -------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("side", ["rowwise", "colwise"])
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_split_quantisation_is_q1_and_jax(dtype, side, shards):
    """Q1a over each shard of the rows, the absmaxes max-reduced, then Q1b on
    the whole rows: Q1 bit for bit, and JAX's eager quantiser of the same
    side (tokens, or the (K, N) kernel's columns)."""
    tdt, jdt = DTYPES[dtype]
    x = _rows()
    xt = torch.from_numpy(x).to(tdt)
    counts = (quant.row_absmax.launches, quant.quantize_rowwise_given.launches)
    m = torch.stack([quant.row_absmax(part) for part in xt.chunk(shards, dim=-1)]).amax(0)
    assert m.dtype == torch.float32 and m.shape == (8, 1)
    q, s = quant.quantize_rowwise_given(xt, m)
    assert (quant.row_absmax.launches, quant.quantize_rowwise_given.launches) == counts  # plain on the CPU
    q1, s1 = quant.quantize_rowwise_plain(xt)
    assert torch.equal(q, q1) and torch.equal(s, s1)
    if side == "rowwise":
        jq, js = jax_quantize_rowwise(jnp.asarray(x, jdt))
    else:
        jq, js = quantize_colwise(jnp.asarray(x.T, jdt))
        jq, js = jnp.transpose(jq), jnp.transpose(js)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    if shards > 1:  # a shard's own absmax is another scale: the reduction matters
        q_own, _ = quant.quantize_rowwise_given(xt[:, :64 // shards], quant.row_absmax(xt[:, :64 // shards]))
        assert not torch.equal(q_own, q[:, :64 // shards])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_matmul_s32_and_dequantisation(dtype):
    """Q2's int32 form is ``torch._int_mm``, exact, over leading dims; the
    PyTorch dequantisation of it is Q2's plain version bit for bit, and the
    int8 linear's on the same (codes, scales)."""
    tdt = DTYPES[dtype][0]
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((3, 7, 96)).astype(np.float32)).to(tdt)
    w = torch.from_numpy((rng.standard_normal((40, 96)) / 10).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(40).astype(np.float32))
    (xq, sx), (wq, sw) = quant.quantize_rowwise(x), quant.quantize_rowwise(w)
    count = quant.int8_matmul_s32.launches
    acc = quant.int8_matmul_s32(xq, wq)
    assert quant.int8_matmul_s32.launches == count
    assert acc.dtype == torch.int32 and acc.shape == (3, 7, 40)
    assert torch.equal(acc.reshape(-1, 40), torch._int_mm(xq.reshape(-1, 96), wq.t()))
    want = quant.int8_product_plain(xq, sx, wq, sw, bias, tdt)
    for got in (quant.dequantize_s32(acc, sx, sw, bias, tdt),
                quant.int8_linear((xq, sx), (wq, sw), bias, tdt), quant.int8_linear(x, w, bias)):
        assert got.dtype == tdt and torch.equal(got, want)


def test_split_forms_refuse_bad_arguments():
    x = torch.zeros(4, 64)
    with pytest.raises(ValueError, match="m must be fp32"):
        quant.quantize_rowwise_given(x, torch.zeros(4))
    with pytest.raises(ValueError, match="m must be fp32"):
        quant.quantize_rowwise_given(x, torch.zeros(4, 1, dtype=torch.float64))
    with pytest.raises(ValueError, match="int8 codes"):
        quant.int8_matmul_s32(x, torch.zeros(8, 64, dtype=torch.int8))
    with pytest.raises(ValueError, match="int8 codes"):
        quant.int8_matmul_s32(torch.zeros(4, 64, dtype=torch.int8), torch.zeros(8, 32, dtype=torch.int8))


# --- the int8 column and row layers on 2 ranks ----------------------------------------


def _layer_operands(m=37, k=128, n=96):
    """x whose tokens keep their absmax in one half of the features or the
    other, so that each rank's shard has its own absmax."""
    rng = np.random.default_rng(k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    x[::2, :k // 2] *= 0.1
    x[1::2, k // 2:] *= 0.1
    w = (rng.standard_normal((n, k)) / np.sqrt(k)).astype(np.float32)
    w[:, :k // 2] *= np.linspace(0.2, 2.0, n, dtype=np.float32)[:, None]
    return x, w, (0.1 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["column", "row"])
def test_int8_tp_layer_is_the_one_rank_linear(pool, kind, dtype):
    """TP = 2: the column layer's outputs, concatenated, and the row layer's
    on each rank are the one-rank ``int8_linear`` on the full operands bit for
    bit, and within ``test_int8_linear_plain_matches_quantdense``'s tolerance
    of JAX's ``QuantDense`` (fp32 rtol 1e-6, bf16 one ulp)."""
    tdt, jdt = DTYPES[dtype]
    x, w, b = _layer_operands()
    got = pool.run(workers.tp_int8_layer, 2, kind, x, w, b, dtype, timeout=120)
    assert got[2:] == [None, None]
    xt = torch.from_numpy(x).to(tdt)
    want = quant.int8_linear(xt, torch.from_numpy(w), torch.from_numpy(b)).float()
    outs = [np.concatenate(got[:2], axis=-1)] if kind == "column" else got[:2]
    for out in outs:
        np.testing.assert_array_equal(out, want.numpy())
    jx = jnp.asarray(xt.float().numpy(), jdt)
    jwant = QuantDense(w.shape[0], dtype=jdt).apply(
        {"params": {"kernel": jnp.asarray(w.T), "bias": jnp.asarray(b)}}, jx)
    if dtype == "float32":
        np.testing.assert_allclose(outs[0], np.asarray(jwant), rtol=1e-6, atol=0)
    else:
        assert _ulps(torch.from_numpy(outs[0]).to(tdt), torch.from_numpy(np.asarray(jwant, np.float32)).to(tdt)) <= 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_layer_without_its_max_reduce_is_caught(pool, dtype):
    """The planted fault: the row layer with its all-reduce MAX left out
    quantises each shard at its own scales; the bit-equality check of the
    test above fails on it, on most outputs."""
    x, w, b = _layer_operands()
    got = pool.run(workers.tp_int8_layer, 2, "row", x, w, b, dtype, True, timeout=120)
    want = quant.int8_linear(torch.from_numpy(x).to(DTYPES[dtype][0]), torch.from_numpy(w),
                             torch.from_numpy(b)).float().numpy()
    for out in got[:2]:
        assert (out != want).mean() > 0.5, (out != want).mean()


# --- the whole net: one train step and one predict forward ---------------------------


def _batch(seed, b, hw=56, k=2):
    rng = np.random.default_rng(seed)
    return {"query/img": rng.standard_normal((b, hw, hw, 3)).astype(np.float32),
            "reference/cross/imgs": rng.standard_normal((b, k, hw, hw, 3)).astype(np.float32),
            "query/score_map": rng.random((b, hw, hw)).astype(np.float32)}


@pytest.fixture(scope="module")
def jax_tp_int8():
    """JAX's tp:model int8 net, jitted on make_mesh(8, model_parallel=2) with
    ``param_shardings``: the initial weights, the batch, the predict
    forward's score maps, the train step's loss and updated parameters."""
    batch = _batch(3, 4)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.device_get(jax.jit(JaxNet(MCFG).init)(jax.random.PRNGKey(0), jb["query/img"][:1],
                                                       jb["reference/cross/imgs"][:1])["params"])
    model = JaxNet(dataclasses.replace(MCFG, attention_impl="tp:model"))
    tx, _ = jax_make_optimizer(jax_load_config("default"), params, steps_per_epoch=10)
    mesh = make_mesh(8, model_parallel=2)
    sparams = jax.device_put(params, param_shardings(params, mesh))
    sbatch = shard_batch(jb, mesh)
    maps = jax.jit(jax_make_predict_step(model))(sparams, sbatch["query/img"], sbatch["reference/cross/imgs"])
    state, metrics = jax.jit(jax_make_train_step(model, tx))(create_train_state(sparams, tx), sbatch)
    return (state_dict_from_jax(params), batch, np.asarray(maps["score_map_ref_cross"]), float(metrics["loss"]),
            state_dict_from_jax(jax.device_get(state.params)))


def _port_cfg(attention_impl, mlp_impl):
    return CrossScoreConfig(backbone=VIT_PRESETS["dinov2-test"], pe_h=6, pe_w=6, decoder_heads=4,
                            compute_dtype=torch.float32, attention_impl=attention_impl, mlp_impl=mlp_impl,
                            backbone_quant="int8")


@pytest.fixture(scope="module")
def port_one_rank(jax_tp_int8):
    """The port's one-rank int8 net (``flash``) on the same weights and batch:
    its score maps, loss and updated parameters."""
    init, batch, *_ = jax_tp_int8
    model = load_into(CrossScoreNet(_port_cfg("flash", "fused"), device="cpu"), init)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    maps = make_predict_step(model)(tb["query/img"], tb["reference/cross/imgs"])["score_map_ref_cross"].numpy()
    optimizer, scheduler, _ = make_optimizer(load_config("default"), model, steps_per_epoch=10)
    _, metrics = make_train_step(model, optimizer, scheduler)(TrainState(), tb)
    return maps, float(metrics["loss"]), {f"model.{k}": v.numpy() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("n,mp,mlp_impl", [(2, 2, "unfused"), (4, 2, "unfused"), (2, 2, "fused_exact")],
                         ids=["tp2", "dp2xtp2", "tp2-whole-mlp"])
def test_tp_int8_net_matches_jax_and_one_rank(pool, jax_tp_int8, port_one_rank, n, mp, mlp_impl):
    """The predict forward's score maps (MAE 1e-4, max 2.5e-3) and, after one
    train step, the loss (rtol 2e-5) and every parameter (atol 2e-5) against
    JAX's jitted tp:model int8 step, and against the port's one-rank int8
    net (the products are exact, so only the attention's summation order
    differs there); the backbone bit-identical; every backbone product through
    the int8 layers (unfused: q/k/v and fc1 column, out and fc2 row; with
    fused_exact requested fc1 and fc2 are whole, the one-rank chain)."""
    init, batch, jmaps, jloss, jparams = jax_tp_int8
    maps1, loss1, params1 = port_one_rank
    got = pool.run(workers.tp_int8_step, n, mp, _port_cfg("tp", mlp_impl), init, batch, [], timeout=300)
    active = [r for r in got if r is not None]
    assert len(active) == n and all(r["round_trip"] for r in active)
    layers = VIT_PRESETS["dinov2-test"].num_layers
    # two backbone passes (the predict forward, the train step) of each layer
    per_pass = {"column": 2 * layers, "row": 2 * layers} if mlp_impl == "unfused" else {"column": layers,
                                                                                      "row": layers}
    for r in active:
        assert r["int8_calls"] == {k: 2 * v for k, v in per_pass.items()}, r["int8_calls"]
    rows = {r["grid"][0]: r["map"] for r in active if r["grid"][1] == 0}
    maps = np.concatenate([rows[d] for d in sorted(rows)])
    for r in active:  # every model rank of a data rank holds its rows' maps
        np.testing.assert_array_equal(r["map"], rows[r["grid"][0]])
    for want, (mae, mx) in ((jmaps, (NET_MAE, NET_MAX)), (maps1, (NET_MAE, NET_MAX))):
        err = np.abs(maps - want)
        assert float(err.mean()) < mae and float(err.max()) < mx, (float(err.mean()), float(err.max()))
    for r in active:
        assert r["loss"] == pytest.approx(jloss, rel=LOSS_RTOL)
        assert r["loss"] == pytest.approx(loss1, rel=LOSS_RTOL)
        for key, val in r["params"].items():
            full = f"model.{key}"
            if key.startswith("backbone.") or key == "pos_enc_fn.PE":
                np.testing.assert_array_equal(val, init[full], err_msg=key)
            else:
                np.testing.assert_allclose(val, jparams[full], atol=PARAM_ATOL, rtol=0, err_msg=key)
                np.testing.assert_allclose(val, params1[full], atol=PARAM_ATOL, rtol=0, err_msg=key)
