"""The port's train slice against the JAX package on the CPU: one train step
(loss and every decoder and head gradient), AdamW updates, the eval-step
metrics and the LR schedule. Parameters are carried across with
``state_dict_from_jax``; inputs come from a numpy seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crossscore_tpu.confsys import load_config as jax_load_config
from crossscore_tpu.models import CrossScoreConfig as JaxConfig
from crossscore_tpu.models import CrossScoreNet as JaxNet
from crossscore_tpu.models.dinov2 import VIT_PRESETS as JAX_VIT
from crossscore_tpu.train import create_train_state
from crossscore_tpu.train import make_eval_step as jax_make_eval_step
from crossscore_tpu.train import make_optimizer as jax_make_optimizer
from crossscore_tpu.train import make_train_step as jax_make_train_step
from crossscore_tpu.train import step_lr_schedule as jax_step_lr_schedule
from crossscore_tpu.train.step import loss_fn as jax_loss_fn
from crossscore_tpu_torch.confsys import load_config
from crossscore_tpu_torch.io.convert import load_into, state_dict_from_jax
from crossscore_tpu_torch.models import VIT_PRESETS, CrossScoreConfig, CrossScoreNet
from crossscore_tpu_torch.train.optim import make_optimizer, step_lr_schedule
from crossscore_tpu_torch.train.step import TrainState, loss_fn, make_eval_step, make_train_step

# the slice's gradients: both packages in fp32 differ by summation order only
GRAD_RTOL = 1e-4


def _batch(seed: int, b: int, k: int, hw: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"query/img": rng.standard_normal((b, hw, hw, 3)).astype(np.float32),
            "reference/cross/imgs": rng.standard_normal((b, k, hw, hw, 3)).astype(np.float32),
            "query/score_map": rng.random((b, hw, hw)).astype(np.float32)}


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _port(preset, pe, params, impl="flash", mlp="fused", dtype=torch.float32, pe_trainable=False):
    cfg = CrossScoreConfig(backbone=VIT_PRESETS[preset], pe_h=pe, pe_w=pe, attention_impl=impl,
                           mlp_impl=mlp, compute_dtype=dtype, pe_trainable=pe_trainable)
    return load_into(CrossScoreNet(cfg, device="cpu"), state_dict_from_jax(params))


@pytest.fixture(scope="module")
def test_params():
    net = JaxNet(JaxConfig(backbone=JAX_VIT["dinov2-test"], pe_h=6, pe_w=6))
    b = _batch(0, 2, 3, 56)
    return jax.device_get(net.init(jax.random.PRNGKey(0), b["query/img"], b["reference/cross/imgs"])["params"])


@pytest.fixture(scope="module")
def small_params():
    net = JaxNet(JaxConfig(backbone=JAX_VIT["dinov2-small"]))
    b = _batch(0, 1, 2, 70)
    return jax.device_get(net.init(jax.random.PRNGKey(1), b["query/img"], b["reference/cross/imgs"])["params"])


CASES = {  # id: (preset, px, B, K, PE side, JAX attention route, JAX MLP route)
    "dinov2-test-jax_xla": ("dinov2-test", 56, 2, 3, 6, "xla", "xla"),
    "dinov2-test-jax_pallas": ("dinov2-test", 56, 2, 3, 6, "pallas", "fused"),
    "dinov2-small-70px": ("dinov2-small", 70, 1, 2, 40, "xla", "xla"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_loss_and_grads_match_jax(case, request):
    preset, hw, b, k, pe, impl, mlp = CASES[case]
    params = request.getfixturevalue("test_params" if preset == "dinov2-test" else "small_params")
    net = JaxNet(JaxConfig(backbone=JAX_VIT[preset], pe_h=pe, pe_w=pe, attention_impl=impl, mlp_impl=mlp))
    batch = _batch(2, b, k, hw)
    (loss_j, _), grads_j = jax.jit(jax.value_and_grad(lambda p, bt: jax_loss_fn(net, p, bt), has_aux=True))(
        params, _jnp(batch))
    want = state_dict_from_jax(jax.device_get(grads_j))
    model = _port(preset, pe, params)
    loss_t, (pred, _, w) = loss_fn(model, _torch(batch))
    loss_t.backward()
    assert w is None and pred.shape == (b, hw, hw)
    assert loss_t.item() == pytest.approx(float(loss_j), rel=GRAD_RTOL)
    checked = 0
    for name, p in model.named_parameters():
        if not name.startswith("ref_cross."):
            assert p.grad is None, name  # backbone and PE: frozen, no gradient
            continue
        g, gw = p.grad.numpy(), want[f"model.{name}"]
        # relative to the leaf's largest entry
        err = float(np.abs(g - gw).max()) / float(np.abs(gw).max())
        assert err <= GRAD_RTOL, (name, err)
        checked += 1
    assert checked == sum(1 for n, _ in model.named_parameters() if n.startswith("ref_cross."))


def _cfgs(extra=()):
    """The same run configured for each package (dinov2-test, fp32)."""
    common = ["model.backbone.preset=dinov2-test", "model.pos_enc.multi_view.h=6",
              "model.pos_enc.multi_view.w=6", *extra]
    jcfg = jax_load_config("default", common + ["model.tpu.compute_dtype=float32",
                                                "model.tpu.attention_impl=xla", "model.tpu.mlp_impl=xla"])
    tcfg = load_config("default", common + ["model.gpu.compute_dtype=float32"])
    return jcfg, tcfg


@pytest.mark.parametrize("pe_trainable", [False, True], ids=["pe_frozen", "pe_req_grad"])
def test_three_adamw_steps_match_jax(test_params, pe_trainable):
    """Parameters after three updates. Bound: 2e-5 absolute, 1/75 of the
    3 * lr = 1.5e-3 each element travels. Adam's first updates are +-lr
    whatever the gradient's size, so the elements whose exact gradient is
    zero (the key bias: softmax ignores a per-row shift) move by
    lr * g / (|g| + eps) on rounding noise that differs between the two
    packages (measured up to 9e-6); every other element agrees to ~4e-6."""
    jcfg, tcfg = _cfgs([f"model.pos_enc.multi_view.req_grad={str(pe_trainable).lower()}"])
    net = JaxNet(JaxConfig.from_config(jcfg))
    batches = [dict(_batch(10 + i, 2, 3, 56), _valid=np.asarray(2, np.int32)) for i in range(3)]
    tx, _ = jax_make_optimizer(jcfg, test_params, steps_per_epoch=2)
    state = create_train_state(test_params, tx)
    step_j = jax.jit(jax_make_train_step(net, tx))
    for bt in batches:
        state, _ = step_j(state, _jnp(bt))
    want = state_dict_from_jax(jax.device_get(state.params))
    init = state_dict_from_jax(test_params)

    mcfg = CrossScoreConfig.from_config(tcfg)
    assert mcfg.pe_trainable == pe_trainable and mcfg.attention_impl == "flash"
    model = load_into(CrossScoreNet(mcfg, device="cpu"), init)
    optimizer, scheduler, _ = make_optimizer(tcfg, model, steps_per_epoch=2)
    step_t = make_train_step(model, optimizer, scheduler)
    st = TrainState()
    for bt in batches:
        st, metrics = step_t(st, _torch(bt))
    assert (st.step, st.epoch, st.batch_in_epoch) == (3, 0, 3)
    assert metrics["pred"].shape == (2, 56, 56)
    for name, p in model.state_dict().items():
        key = f"model.{name}"
        got = p.numpy()
        if name.startswith("backbone.") or (name == "pos_enc_fn.PE" and not pe_trainable):
            np.testing.assert_array_equal(got, init[key], err_msg=name)
        else:
            np.testing.assert_allclose(got, want[key], atol=2e-5, rtol=0, err_msg=name)
    pe_moved = float(np.abs(model.pos_enc_fn.PE.detach().numpy() - init["model.pos_enc_fn.PE"]).max())
    assert (pe_moved > 1e-4) == pe_trainable


@pytest.mark.parametrize("pad", ["none", "valid", "valid_mask"])
def test_eval_step_metrics_match_jax(test_params, pad):
    """The eval metrics, with the loader's padded duplicate rows weighted out
    (the ``_valid`` prefix count or its per-row ``_valid_mask`` form)."""
    net = JaxNet(JaxConfig(backbone=JAX_VIT["dinov2-test"], pe_h=6, pe_w=6))
    batch = _batch(20, 3, 2, 56)
    if pad == "valid":
        batch["_valid"] = np.asarray(2, np.int32)
    elif pad == "valid_mask":
        batch["_valid_mask"] = np.asarray([1.0, 0.0, 1.0], np.float32)
    pred_j, m_j = jax.jit(jax_make_eval_step(net))(test_params, _jnp(batch))
    pred_t, m_t = make_eval_step(_port("dinov2-test", 6, test_params))(_torch(batch))
    np.testing.assert_allclose(pred_t.numpy(), np.asarray(pred_j), atol=1e-5, rtol=0)
    assert set(m_t) == set(m_j)
    for key in m_j:
        assert float(m_t[key]) == pytest.approx(float(m_j[key]), rel=1e-4, abs=1e-6), key


def test_step_lr_schedule_and_optimizer_lr_follow_jax():
    """StepLR across epoch boundaries (3 steps per epoch, decay every 2
    epochs), and the optimiser's lr at update t equals schedule(t)."""
    want = jax_step_lr_schedule(5e-4, 2, 0.5, steps_per_epoch=3)
    got = step_lr_schedule(5e-4, 2, 0.5, steps_per_epoch=3)
    assert [got(t) for t in range(20)] == [pytest.approx(float(want(t)), rel=1e-7) for t in range(20)]
    assert got(5) == 5e-4 and got(6) == 2.5e-4 and got(12) == 1.25e-4
    _, tcfg = _cfgs(["trainer.lr_scheduler.step_size=2"])
    model = torch.nn.Linear(2, 1)
    optimizer, scheduler, schedule = make_optimizer(tcfg, model, steps_per_epoch=3)
    seen = []
    for _ in range(14):
        seen.append(optimizer.param_groups[0]["lr"])
        optimizer.step()
        scheduler.step()
    assert seen == [pytest.approx(schedule(t), rel=1e-12) for t in range(14)]
    with pytest.raises(ValueError, match="step_interval"):
        step_lr_schedule(1.0, 1, 0.5, 3, interval="month")


def test_trainable_parameters_and_optimizer_state(test_params):
    """The JAX ``trainable_mask``: decoder and head train, the backbone never,
    the PE only under ``req_grad``; frozen parameters get no optimiser state."""
    for pe_trainable in (False, True):
        model = _port("dinov2-test", 6, test_params, pe_trainable=pe_trainable)
        for name, p in model.named_parameters():
            expect = name.startswith("ref_cross.") or (name == "pos_enc_fn.PE" and pe_trainable)
            assert p.requires_grad == expect, name
        _, tcfg = _cfgs()
        optimizer, _, _ = make_optimizer(tcfg, model, steps_per_epoch=1)
        held = {id(p) for group in optimizer.param_groups for p in group["params"]}
        assert held == {id(p) for p in model.parameters() if p.requires_grad}


def test_bf16_train_step_matches_jax_loosely(test_params):
    """bf16 on both sides (JAX pallas + fused, the port's K3/K4 + K2 plain
    versions). The frameworks round at different places, so the bound is
    loose: 1e-3 on the loss and, per decoder/head leaf, a relative L2 error
    of 0.1. Each side's own bf16 gradient is 5-10% (L2) away from the fp32
    gradient at this size, and the two roundings are independent."""
    net = JaxNet(JaxConfig(backbone=JAX_VIT["dinov2-test"], pe_h=6, pe_w=6, attention_impl="pallas",
                           mlp_impl="fused", compute_dtype=jnp.bfloat16))
    batch = _batch(30, 2, 3, 56)
    (loss_j, _), grads_j = jax.jit(jax.value_and_grad(lambda p, bt: jax_loss_fn(net, p, bt), has_aux=True))(
        test_params, _jnp(batch))
    want = state_dict_from_jax(jax.device_get(grads_j))
    model = _port("dinov2-test", 6, test_params, dtype=torch.bfloat16)
    loss_t, _ = loss_fn(model, _torch(batch))
    loss_t.backward()
    assert loss_t.item() == pytest.approx(float(loss_j), rel=1e-3)
    for name, p in model.named_parameters():
        if p.grad is not None:
            assert p.grad.dtype == torch.float32
            gw = want[f"model.{name}"]
            err = float(np.linalg.norm(p.grad.numpy() - gw)) / float(np.linalg.norm(gw))
            assert err <= 0.1, (name, err)


def test_unported_batch_forms_raise(test_params):
    """Bucket-padded batches (``_valid_hw``) are ported: an extent that
    covers the whole image weighs nothing out, on pixel and token batches
    alike (the token graph is not given the extent, as in JAX: only the
    weights read it); a malformed extent raises in the model, and so does a
    bucketed batch under autograd (K5/K6 are forward only, eval's kernels)."""
    model = _port("dinov2-test", 6, test_params)
    batch = _torch(_batch(40, 1, 1, 56))
    with pytest.raises(RuntimeError, match="forward only"):
        loss_fn(model, dict(batch, _valid_hw=np.asarray([56, 56])))
    torch.set_grad_enabled(False)
    try:
        whole, _ = loss_fn(model, batch)
        for vhw in (np.asarray([56, 56]), np.asarray([[56, 56]]), torch.tensor([56, 60])):
            assert loss_fn(model, dict(batch, _valid_hw=vhw))[0].item() == whole.item()
        with pytest.raises(ValueError, match="valid_hw must be"):
            loss_fn(model, dict(batch, _valid_hw=np.asarray([56, 56, 3])))
    finally:
        torch.set_grad_enabled(True)
    tokens = {"query/tokens": torch.zeros(1, 16, 64), "reference/cross/tokens": torch.zeros(1, 1, 16, 64),
              "query/score_map": torch.zeros(1, 56, 56)}
    loss, (_, l1, w) = loss_fn(model, dict(tokens, _valid_hw=np.asarray([28, 56])))
    assert float(w.sum()) == 28 * 56 and loss.item() == pytest.approx(l1[:, :28].mean().item(), rel=1e-6)
