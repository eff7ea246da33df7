"""The eval path's pieces in the port against the JAX package on the CPU: the
masked weights of ``train/step.py::_weights`` in every form of ``_valid``,
``_valid_mask`` and ``_valid_hw`` (exact), ``make_eval_step`` on a
bucket-padded batch, and the offline summariser (``ScoreReader``,
``SummaryWriterGroundTruth``, ``SummaryReader``) with its CLI
``tasks.summarise_score_gt`` (byte-equal CSVs). Inputs come from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from crossscore_tpu.io.summariser import ScoreReader as JaxScoreReader
from crossscore_tpu.io.summariser import SummaryReader as JaxSummaryReader
from crossscore_tpu.io.summariser import SummaryWriterGroundTruth as JaxSummaryWriterGroundTruth
from crossscore_tpu.models import CrossScoreConfig as JaxConfig
from crossscore_tpu.models import CrossScoreNet as JaxNet
from crossscore_tpu.models import ViTConfig as JaxViT
from crossscore_tpu.tasks.summarise_score_gt import main as jax_summarise_main
from crossscore_tpu.train.step import _weights as jax_weights
from crossscore_tpu.train.step import make_eval_step as jax_make_eval_step
from crossscore_tpu_torch.data.synthetic import generate
from crossscore_tpu_torch.io.convert import load_into, state_dict_from_jax
from crossscore_tpu_torch.io.summariser import ScoreReader, SummaryReader, SummaryWriterGroundTruth
from crossscore_tpu_torch.models import VIT_PRESETS, CrossScoreConfig, CrossScoreNet, ViTConfig
from crossscore_tpu_torch.tasks.summarise_score_gt import main as summarise_main
from crossscore_tpu_torch.train.step import _weights, make_eval_step

VIT = dict(hidden_size=64, num_layers=2, num_heads=4, patch_size=14, image_size=56)
# fp32 eval metrics against JAX (the masked net's bound, tests/test_torch_masked.py)
TOL = 1e-4

B, H, W = 3, 84, 98
WEIGHT_FORMS = {
    "valid": {"_valid": np.asarray(2, np.int32)},
    "valid_mask": {"_valid_mask": np.asarray([1.0, 0.0, 1.0], np.float32)},
    "hw_shared": {"_valid_hw": np.asarray([70, 83], np.int32)},
    "hw_item": {"_valid_hw": np.asarray([[84, 98], [56, 70], [43, 97]], np.int32)},
    "hw_shared_valid": {"_valid_hw": np.asarray([70, 83], np.int32), "_valid": np.asarray(1, np.int32)},
    "hw_item_valid": {"_valid_hw": np.asarray([[84, 98], [56, 70], [56, 70]], np.int32),
                      "_valid": np.asarray(2, np.int32)},
    "hw_item_valid_mask": {"_valid_hw": np.asarray([[84, 98], [56, 70], [43, 97]], np.int32),
                           "_valid_mask": np.asarray([0.0, 1.0, 1.0], np.float32)},
    "none": {},
}


@pytest.mark.parametrize("patch", [VIT_PRESETS["dinov2-test"].patch_size, 16])
@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("form", list(WEIGHT_FORMS))
def test_weights_match_jax_exactly(form, as_tensor, patch):
    """Every form of the padding, as numpy (the host loader's) or tensors,
    floored to the model's patch size (after tests/test_eval_masking.py)."""
    batch = WEIGHT_FORMS[form]
    want = jax_weights({k: jnp.asarray(v) for k, v in batch.items()}, (B, H, W), patch=patch)
    got = _weights({k: torch.from_numpy(v) if as_tensor else v for k, v in batch.items()}, (B, H, W), patch)
    if form == "none":
        assert want is None and got is None
        return
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, H, W)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_weights_floor_to_the_patch():
    w14 = _weights({"_valid_hw": np.asarray([20, 33])}, (1, 42, 42), patch=14)
    w16 = _weights({"_valid_hw": np.asarray([20, 33])}, (1, 42, 42), patch=16)
    assert float(w14[0, :, 0].sum()) == 14 and float(w14[0, 0, :].sum()) == 28
    assert float(w16[0, :, 0].sum()) == 16 and float(w16[0, 0, :].sum()) == 32


@pytest.fixture(scope="module")
def jax_params():
    model = JaxNet(JaxConfig(backbone=JaxViT(**VIT), pe_h=6, pe_w=6, decoder_heads=4))
    rng = np.random.default_rng(0)
    q = jnp.asarray(rng.standard_normal((1, 56, 56, 3)).astype(np.float32))
    r = jnp.asarray(rng.standard_normal((1, 2, 56, 56, 3)).astype(np.float32))
    return jax.device_get(model.init(jax.random.PRNGKey(0), q, r)["params"])


@pytest.fixture(scope="module")
def padded_batch():
    """A bucket-packed eval batch in an 84x84 bucket, K=2: two extents, and a
    third item that duplicates the second as the loader's padding."""
    rng = np.random.default_rng(11)
    q = rng.standard_normal((3, 84, 84, 3)).astype(np.float32)
    r = rng.standard_normal((3, 2, 84, 84, 3)).astype(np.float32)
    sm = rng.random((3, 84, 84)).astype(np.float32)
    q[2], r[2], sm[2] = q[1], r[1], sm[1]
    return {"query/img": q, "reference/cross/imgs": r, "query/score_map": sm,
            "_valid": np.asarray(2, np.int32), "_valid_hw": np.asarray([[84, 84], [56, 70], [56, 70]], np.int32)}


@pytest.mark.parametrize("impl", ["flash", "dense"])
@pytest.mark.parametrize("form", ["item", "shared"])
def test_eval_step_on_a_padded_batch_matches_jax(jax_params, padded_batch, impl, form):
    """Loss, PSNR and correlation of ``make_eval_step`` within 1e-4 of the
    JAX step's on the same weights and batch: padding and duplicates are
    weighed out on both sides."""
    batch = dict(padded_batch)
    if form == "shared":
        batch["_valid_hw"] = batch["_valid_hw"][1]
    jax_model = JaxNet(JaxConfig(backbone=JaxViT(**VIT), pe_h=6, pe_w=6, decoder_heads=4, attention_impl="xla",
                                 mlp_impl="xla"))
    pred_j, want = jax.jit(jax_make_eval_step(jax_model))(jax_params, {k: jnp.asarray(v) for k, v in batch.items()})
    cfg = CrossScoreConfig(backbone=ViTConfig(**VIT), pe_h=6, pe_w=6, decoder_heads=4, attention_impl=impl,
                           mlp_impl="fused_exact" if impl == "flash" else "unfused", compute_dtype=torch.float32)
    model = load_into(CrossScoreNet(cfg, device="cpu"), state_dict_from_jax(jax_params))
    tensors = {k: v if k == "_valid_hw" else torch.from_numpy(v) for k, v in batch.items()}
    pred_t, got = make_eval_step(model)(tensors)
    for key in ("loss", "loss_cross", "psnr_cross", "correlation_cross"):
        assert float(got[key]) == pytest.approx(float(want[key]), abs=TOL), key
    ch, cw = 56, 70  # the second item's valid jigsaw extent
    assert float(np.abs(pred_t[1, :ch, :cw].numpy() - np.asarray(pred_j)[1, :ch, :cw]).mean()) < TOL


def test_eval_step_weighs_out_padding(jax_params, padded_batch):
    """The padded batch's metrics equal those of the batch cut to its two
    valid items, and the bucket padding of the second changes nothing."""
    cfg = CrossScoreConfig(backbone=ViTConfig(**VIT), pe_h=6, pe_w=6, decoder_heads=4, compute_dtype=torch.float32)
    step = make_eval_step(load_into(CrossScoreNet(cfg, device="cpu"), state_dict_from_jax(jax_params)))
    full = {k: v if k == "_valid_hw" else torch.from_numpy(v) for k, v in padded_batch.items()}
    _, padded = step(full)
    cut = {k: v[:2] for k, v in full.items() if k not in ("_valid", "_valid_hw")}
    _, unweighted = step(cut)
    _, two = step(dict(cut, _valid_hw=padded_batch["_valid_hw"][:2]))
    assert float(padded["loss"]) == pytest.approx(float(two["loss"]), rel=1e-6)
    assert float(padded["correlation_cross"]) == pytest.approx(float(two["correlation_cross"]), rel=1e-5)
    assert abs(float(two["loss"]) - float(unweighted["loss"])) > 1e-3  # the padding is in the unweighted loss


# --- the offline summariser ------------------------------------------------------


@pytest.fixture(scope="module")
def gt_tree(tmp_path_factory):
    """A seeded tree in the reference's ``<method>/<dataset>/res_*`` layout."""
    root = tmp_path_factory.mktemp("gt_tree") / "gaussian" / "mip360"
    generate(root, hw=(28, 42), scenes_per_split={"train": 2, "val": 1, "test": 1}, n_train_imgs=3,
             n_test_imgs=2, seed=4)
    return root / "res_540"


def test_score_reader_matches_jax(gt_tree):
    dirs = sorted(str(p) for p in gt_tree.rglob("metric_map"))
    got, want = ScoreReader(dirs), JaxScoreReader(dirs)
    assert len(got) == len(want) == 4 * (3 + 2)
    np.testing.assert_array_equal(got.read_paths_all, want.read_paths_all)
    for i in (0, 7, len(got) - 1):
        assert got[i] == want[i]


@pytest.mark.parametrize("fast_debug", [0, 1])
def test_gt_summary_csv_byte_equal_to_jax(gt_tree, tmp_path, fast_debug):
    got_dir, want_dir = tmp_path / "port", tmp_path / "jax"
    SummaryWriterGroundTruth(gt_tree, got_dir, num_workers=2, fast_debug=fast_debug).write_csv()
    JaxSummaryWriterGroundTruth(gt_tree, want_dir, num_workers=2, fast_debug=fast_debug).write_csv()
    got, want = got_dir / "mip360" / "gaussian.csv", want_dir / "mip360" / "gaussian.csv"
    assert got.read_bytes() == want.read_bytes()
    assert len(pd.read_csv(got)) == (16 if fast_debug else 20)


def test_summarise_score_gt_cli_and_reader_match_jax(gt_tree, tmp_path, capsys):
    """The CLI with the JAX CLI's arguments; a second run skips, ``-f``
    rewrites; the reader's selections and its row check equal JAX's."""
    got_dir, want_dir = tmp_path / "port", tmp_path / "jax"
    for main, out in ((summarise_main, got_dir), (jax_summarise_main, want_dir)):
        main(["--dir_in", str(gt_tree), "--dir_out", str(out), "-n", "2"])
    csv = got_dir / "mip360" / "gaussian.csv"
    assert csv.read_bytes() == (want_dir / "mip360" / "gaussian.csv").read_bytes()
    csv.write_text("stale")
    summarise_main(["--dir_in", str(gt_tree), "--dir_out", str(got_dir)])
    assert "(SKIP)" in capsys.readouterr().out and csv.read_text() == "stale"
    summarise_main(["--dir_in", str(gt_tree), "--dir_out", str(got_dir), "-f", "--fast_debug", "-1"])
    assert csv.read_bytes() == (want_dir / "mip360" / "gaussian.csv").read_bytes()
    for scenes, splits, iters in (([""], [""], []), (["s00000"], ["test"], [1000]), ([""], ["train"], [7])):
        got = SummaryReader.read_summary(got_dir, "mip360", ["gaussian"], scenes, splits, iters)
        want = JaxSummaryReader.read_summary(want_dir, "mip360", ["gaussian"], scenes, splits, iters)
        pd.testing.assert_frame_equal(got, want)
    full = SummaryReader.read_summary(got_dir, "mip360", [""], [""], [""], [])
    assert len(full) == 20 and set(full["method_name"]) == {"gaussian"}
    SummaryReader.check_summary_gt_prediction_rows(full, full)
    with pytest.raises(ValueError, match="different length"):
        SummaryReader.check_summary_gt_prediction_rows(full, full[1:])
    with pytest.raises(ValueError, match="nerfacto is not available"):
        SummaryReader.read_summary(got_dir, "mip360", ["nerfacto"], [""], [""], [])
