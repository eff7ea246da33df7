"""A dry run of the port's multi-rank paths at tiny shapes: the counterpart of
the JAX ``__graft_entry__.dryrun_multichip``, with ranks for devices.

    python -m crossscore_tpu_torch.tools.dryrun_multichip N [--cpu]

Spawns N ranks (``parallel.launch.RankPool``) joined over gloo: on the CPU
with ``--cpu``, or sharing the card (gloo stages the collectives through the
host; NCCL takes one rank per card). The ranks form the (data, model) grid of
the JAX mesh, ``model_parallel`` 2 when N is even and at least 4, and run at
the JAX tiny shapes (hidden 64, 4 heads, 2 blocks, 56 px, K 2, B 2N, fp32):

1. one full train step on the ``tp`` route (``flash`` when ``model_parallel``
   is 1), each data rank its rows: step 1 and a finite loss, the same on
   every rank;
2. the view-parallel forward, K = N views over every rank (``cp``): finite,
   and equal to the one-rank net on every view;
3. the bucket-packed masked eval step (per-item ``_valid_hw``, the last row
   a padded duplicate) over the data group: a finite loss equal to the
   one-rank step's on the global batch;
4. the cached step (reference tokens from the backbone encoder) on each data
   rank's rows against the whole batch's rows;
5. the view-parallel token forward on half the ranks (all of them when N is
   odd) against the dense cached forward;
6. the token train step (the decoder-only graph) over the data group: step 1
   and a finite loss.

Exits 0 when every check holds; prints one line per phase from rank 0.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

B_PER_RANK, HW, K, TOL = 2, 56, 2, 1e-4


def _tiny(attention_impl: str):
    import torch

    from crossscore_tpu_torch.models import CrossScoreConfig
    from crossscore_tpu_torch.models.dinov2 import ViTConfig

    vit = ViTConfig(hidden_size=64, num_layers=2, num_heads=4, patch_size=14, image_size=HW)
    return CrossScoreConfig(backbone=vit, pe_h=6, pe_w=6, decoder_heads=4, attention_impl=attention_impl,
                            compute_dtype=torch.float32, mlp_impl="fused_exact")


def _max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def _rank(device_type: str, n: int) -> dict:
    """Every phase on this rank -> its readings (rank 0's hold the checks)."""
    import torch
    import torch.distributed as dist

    from crossscore_tpu_torch.confsys import load_config
    from crossscore_tpu_torch.io.convert import init_params, load_into
    from crossscore_tpu_torch.models import CrossScoreNet
    from crossscore_tpu_torch.models.crossscore import make_backbone_encoder
    from crossscore_tpu_torch.parallel import mesh
    from crossscore_tpu_torch.parallel.tensor_parallel import shard_state_dict
    from crossscore_tpu_torch.parallel.view_parallel import (
        make_view_parallel_apply, make_view_parallel_apply_tokens, view_shard,
    )
    from crossscore_tpu_torch.train.optim import make_optimizer
    from crossscore_tpu_torch.train.step import TrainState, make_eval_step, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, dev = mesh.init_distributed("gloo", device_type)
    try:
        mp = 2 if n % 2 == 0 and n >= 4 else 1
        grid = mesh.make_groups(mp)
        b = B_PER_RANK * n
        rng = np.random.default_rng(0)
        host = {"query/img": rng.standard_normal((b, HW, HW, 3)).astype(np.float32),
                "reference/cross/imgs": rng.standard_normal((b, K, HW, HW, 3)).astype(np.float32),
                "query/score_map": rng.random((b, HW, HW)).astype(np.float32)}
        batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        rows = b // grid.data_parallel
        mine = slice(grid.data_rank * rows, (grid.data_rank + 1) * rows)
        out: dict = {"grid": (grid.data_parallel, grid.model_parallel)}
        tcfg = load_config("default")

        # 1. one train step on the tp route, each data rank its rows
        plain = _tiny("flash")
        full = init_params(plain, 0, dev)
        cfg = _tiny("tp" if mp > 1 else "flash")
        state = shard_state_dict(full, grid.model_rank, mp, cfg.mlp_impl) if mp > 1 else full
        model = load_into(CrossScoreNet(cfg, device=dev), state)
        optimizer, scheduler, _ = make_optimizer(tcfg, model, steps_per_epoch=100)
        st, metrics = make_train_step(model, optimizer, scheduler)(TrainState(), {k: v[mine] for k, v in
                                                                                  batch.items()})
        out["train"] = {"step": st.step, "loss": float(metrics["loss"])}

        # 2. the view-parallel forward: K = n views over every rank
        g = np.random.default_rng(1)
        refs_k = torch.from_numpy(g.standard_normal((1, n, HW, HW, 3)).astype(np.float32)).to(dev)
        query1 = torch.from_numpy(np.random.default_rng(2).standard_normal((1, HW, HW, 3))
                                  .astype(np.float32)).to(dev)
        vp_full = init_params(plain, 1, dev)
        vp_model = load_into(CrossScoreNet(_tiny("cp"), device=dev), vp_full)
        dense = load_into(CrossScoreNet(plain, device=dev), vp_full)
        with torch.no_grad():
            vp_out = make_view_parallel_apply(vp_model)(query1, refs_k[:, view_shard(n)])
            dense_out = dense(query1, refs_k)["score_map_ref_cross"]
        out["vp"] = {"finite": bool(torch.isfinite(vp_out).all()), "max_abs": _max_abs(vp_out, dense_out)}

        # 3. the bucket-packed masked eval step over the data group
        eval_model = load_into(CrossScoreNet(plain, device=dev), full)
        vhw = np.tile(np.asarray([[HW, HW], [42, HW]], np.int32), (b // 2, 1))
        mask = (np.arange(b) < b - 1).astype(np.float32)
        packed = {**{k: v[mine] for k, v in batch.items()}, "_valid_mask": torch.from_numpy(mask[mine]).to(dev),
                  "_valid": torch.tensor(int(mask[mine].sum()), device=dev), "_valid_hw": vhw[mine]}
        _, m_dp = make_eval_step(eval_model)(packed)
        whole = {**batch, "_valid": torch.tensor(b - 1, device=dev), "_valid_hw": vhw}
        _, m_one = make_eval_step(eval_model, data_parallel=False)(whole)
        out["bucketed"] = {"loss": float(m_dp["loss"]), "loss_one_rank": float(m_one["loss"]),
                           "corr": float(m_dp["correlation_cross"]),
                           "corr_one_rank": float(m_one["correlation_cross"])}

        # 4. the cached step: each data rank's rows against the whole batch's
        encode = make_backbone_encoder(plain)
        with torch.no_grad():
            flat = batch["reference/cross/imgs"].reshape(b * K, HW, HW, 3)
            tokens = encode(eval_model, flat)
            tokens = tokens.reshape(b, K, *tokens.shape[1:])
            whole_c = eval_model(batch["query/img"], None, ref_tokens=tokens)["score_map_ref_cross"]
            rows_c = eval_model(batch["query/img"][mine], None, ref_tokens=tokens[mine])["score_map_ref_cross"]
        out["cached"] = {"finite": bool(torch.isfinite(rows_c).all()), "max_abs": _max_abs(rows_c, whole_c[mine])}

        # 5. cache x view parallel on a sub-group of the ranks ("one node")
        n_sub = n // 2 if n % 2 == 0 else n
        sub = dist.new_group(list(range(n_sub)))
        with torch.no_grad():
            tok_k = encode(eval_model, refs_k.reshape(n, HW, HW, 3))
            tok_k = tok_k.reshape(1, n, *tok_k.shape[1:])
            dense_t = eval_model(query1, None, ref_tokens=tok_k)["score_map_ref_cross"]
            if dist.get_rank() < n_sub:
                mesh.set_view_group(sub)
                vpt_model = load_into(CrossScoreNet(_tiny("cp"), device=dev), full)
                vpt = make_view_parallel_apply_tokens(vpt_model)(query1, tok_k[:, view_shard(n)])
                out["vp_tokens"] = {"n_ranks": n_sub, "max_abs": _max_abs(vpt, dense_t)}
                mesh.set_view_group(dist.group.WORLD)

        # 6. the token train step (decoder-only) over the data group
        n_tok = (HW // 14) ** 2
        t = np.random.default_rng(3)
        token_batch = {"query/tokens": t.standard_normal((b, n_tok, 64)).astype(np.float32),
                       "reference/cross/tokens": t.standard_normal((b, K, n_tok, 64)).astype(np.float32),
                       "query/score_map": t.random((b, HW, HW)).astype(np.float32)}
        tok_model = load_into(CrossScoreNet(plain, device=dev), full)
        optimizer, scheduler, _ = make_optimizer(tcfg, tok_model, steps_per_epoch=100)
        st2, m2 = make_train_step(tok_model, optimizer, scheduler)(
            TrainState(), {k: torch.from_numpy(v[mine]).to(dev) for k, v in token_batch.items()})
        out["token_train"] = {"step": st2.step, "loss": float(m2["loss"])}
        dist.barrier()
        return out
    finally:
        mesh.teardown()


def check(results: list) -> list[str]:
    """The failed checks over every rank's readings (empty when all hold)."""
    bad = []
    r0 = results[0]
    losses = {r["train"]["loss"] for r in results}
    if any(r["train"]["step"] != 1 for r in results) or not all(np.isfinite(x) for x in losses) \
            or max(losses) - min(losses) > TOL:
        bad.append(f"train step: {[r['train'] for r in results]}")
    if not all(r["vp"]["finite"] and r["vp"]["max_abs"] <= TOL for r in results):
        bad.append(f"view-parallel forward: {[r['vp'] for r in results]}")
    for r in results:
        bk = r["bucketed"]
        if not (np.isfinite(bk["loss"]) and abs(bk["loss"] - bk["loss_one_rank"]) <= TOL
                and abs(bk["corr"] - bk["corr_one_rank"]) <= TOL):
            bad.append(f"bucket-packed eval: {bk}")
            break
    if not all(r["cached"]["finite"] and r["cached"]["max_abs"] <= TOL for r in results):
        bad.append(f"cached step: {[r['cached'] for r in results]}")
    if not all(r["vp_tokens"]["max_abs"] <= TOL for r in results if "vp_tokens" in r):
        bad.append(f"view-parallel token forward: {[r.get('vp_tokens') for r in results]}")
    if any(r["token_train"]["step"] != 1 or not np.isfinite(r["token_train"]["loss"]) for r in results):
        bad.append(f"token train step: {[r['token_train'] for r in results]}")
    if r0["grid"][0] * r0["grid"][1] != len(results):
        bad.append(f"grid {r0['grid']} over {len(results)} ranks")
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, help="ranks to spawn")
    ap.add_argument("--cpu", action="store_true", help="gloo ranks on the CPU (the plain versions)")
    args = ap.parse_args(argv)
    import torch

    from crossscore_tpu_torch.parallel.launch import RankPool

    if args.n < 2:
        print("dryrun_multichip needs at least 2 ranks", file=sys.stderr)
        return 2
    if not args.cpu and not torch.cuda.is_available():
        print("no CUDA device: pass --cpu to run the ranks on the CPU", file=sys.stderr)
        return 1
    with RankPool(args.n, env={"OMP_NUM_THREADS": "1"}) as pool:
        results = pool.run(_rank, "cpu" if args.cpu else "cuda", args.n, timeout=600)
    r0 = results[0]
    print(f"dryrun_multichip: grid (data, model) = {r0['grid']}, batch {B_PER_RANK * args.n}, "
          f"{'cpu' if args.cpu else torch.cuda.get_device_name(0)}")
    print(f"  tp train step: loss {r0['train']['loss']:.6f} (every rank: "
          f"{[round(r['train']['loss'], 6) for r in results]})")
    print(f"  view-parallel forward, K={args.n} over {args.n} ranks: max |d| against one rank "
          f"{max(r['vp']['max_abs'] for r in results):.3e}")
    print(f"  bucket-packed masked eval over the data group: loss {r0['bucketed']['loss']:.6f}, one rank "
          f"{r0['bucketed']['loss_one_rank']:.6f}")
    print(f"  cached step: max |d| of each rank's rows {max(r['cached']['max_abs'] for r in results):.3e}")
    print(f"  view-parallel token forward over {r0['vp_tokens']['n_ranks']} ranks: max |d| against dense "
          f"{max(r['vp_tokens']['max_abs'] for r in results if 'vp_tokens' in r):.3e}")
    print(f"  token train step: loss {r0['token_train']['loss']:.6f}")
    bad = check(results)
    if bad:
        print("dryrun_multichip FAILED: " + "; ".join(bad))
        return 1
    print(f"dryrun_multichip OK ({args.n} ranks, tolerance {TOL:.0e})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
