"""A/B microbenchmark of the attention kernels and their timing modes; the
counterpart of the TPU tool ``tools/attn_microbench.py``.

    python -m crossscore_tpu_torch.tools.attn_microbench [--cpu] [--seed N] [--reps N] \\
        [--layers N] [--decoder] SPEC [SPEC ...]

Shapes: the backbone's self-attention at the predict point (72 views, 6
heads, 1370 tokens, hd 64), or with ``--decoder`` (or ``ATTN_BENCH_DEC`` set)
the decoder's cross-attention (B 8, 8 heads, 1369 queries over 10952 keys, hd
48). A timed run chains ``--layers`` calls (``ATTN_BENCH_LAYERS``; 12 for the
backbone, 4 for the decoder), each fed the previous call's output as its
queries; a spec's time is the median of ``--reps`` (at least 5) runs after two
warm-up runs, by CUDA events, per layer. It prints ms per layer, TFLOP/s at
4 B H Nq Nk hd operations, and the largest |difference| of the spec's output
from the first spec's on the same inputs (not for the wrong-math probes).

Specs keep the TPU tool's grammar and names ``<name>:<params>``:

    v1, v2, v2noaug:<bq>,<bk>,<bh>   K7, the head-major forward (on the TPU v1
                                     and v2 are two bodies and v2noaug v2
                                     without its ones column: one function)
    v2bf16:<bq>,<bk>,<bh>            K7' bf16exp: exp2 in bf16
    v2noexp:<bq>,<bk>,<bh>           K7' noexp: no exp2 (wrong math)
    v2mxu:<bq>,<bk>,<bh>             K7' mxuprobe: QK -> cast -> PV (wrong math)
    qkv:<bq>,<hpack>[,<chunks>]      K1 off the fused qkv; K11 chunks if > 1
    qkvc:<bq>,<hpack>,<chunks>       K11 chunks: split-KV with a combine
    qkvp:<bq>,<hpack>,<probe>        K11 probe nomax, nosum or mxu (wrong math)
    xln:<bq>,<bk>                    K3 on token-major projections

The TPU tile sizes (block_q, block_k, block_h, hpack) choose nothing on
CUDA: they are parsed and reported as unused. The qkv specs need the
backbone shape (queries and keys are one token axis). A Mosaic scheduling
token (``qkv:688,2,1,allpar``) is refused. ``--cpu`` runs the plain versions
at small shapes; without it the tool needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from crossscore_tpu_torch.ops import flash_attention as fa
from crossscore_tpu_torch.tools._common import device_line, median_ms, resolve_device

# (B, H, Nq, Nk, hd) on the card and, with --cpu, for the plain versions
SHAPES = {"backbone": (72, 6, 1370, 1370, 64), "decoder": (8, 8, 1369, 8 * 1369, 48)}
CPU_SHAPES = {"backbone": (1, 2, 128, 128, 64), "decoder": (1, 2, 64, 256, 48)}
HEAD_MAJOR = {"v1": None, "v2": None, "v2noaug": None, "v2bf16": "bf16exp", "v2noexp": "noexp",
              "v2mxu": "mxuprobe"}
TILE_NAMES = {"head_major": ("block_q", "block_k", "block_h"), "qkv": ("block_q", "hpack"),
              "xln": ("block_q", "block_k")}


def parse_spec(spec: str) -> dict:
    """``<name>:<params>`` -> {"spec", "name", "kind", "tiles": {...}, "chunks",
    "probe", "variant"}; raises ValueError for an unknown or malformed spec
    and for a Mosaic scheduling token."""
    name, sep, params = spec.partition(":")
    parts = params.split(",") if sep else []
    if name in HEAD_MAJOR:
        kind, n_tiles = "head_major", 3
    elif name in ("qkv", "qkvc", "qkvp"):
        kind, n_tiles = "qkv", 2
    elif name == "xln":
        kind, n_tiles = "xln", 2
    else:
        raise ValueError(f"{spec}: unknown spec name {name!r}")
    if len(parts) < n_tiles or not all(p.isdigit() for p in parts[:n_tiles]):
        raise ValueError(f"{spec}: expected {name}:{','.join(TILE_NAMES[kind])}...")
    out = {"spec": spec, "name": name, "kind": kind, "tiles": dict(zip(TILE_NAMES[kind], map(int, parts[:n_tiles]))),
           "chunks": 1, "probe": None, "variant": HEAD_MAJOR.get(name)}
    rest = parts[n_tiles:]
    if name == "qkvp":
        if len(rest) != 1 or rest[0] not in fa.QKV_PROBES:
            raise ValueError(f"{spec}: expected qkvp:<block_q>,<hpack>,<probe> with probe in "
                             f"{sorted(fa.QKV_PROBES)}")
        out["probe"] = rest[0]
    elif name in ("qkv", "qkvc"):
        if rest and not rest[-1].isdigit():
            raise ValueError(f"{spec}: {rest[-1]!r} is a Mosaic scheduling token of the TPU kernel; "
                             "there is no counterpart on CUDA")
        if len(rest) > 1 or (name == "qkvc" and not rest):
            raise ValueError(f"{spec}: expected {name}:<block_q>,<hpack>{',<chunks>' if name == 'qkvc' else '[,<chunks>]'}")
        out["chunks"] = int(rest[0]) if rest else 1
    elif rest:
        raise ValueError(f"{spec}: unexpected parameters {rest}")
    return out


def _runner(sp: dict, q, k, v, h: int):
    """(one call on the pristine inputs -> head-major o, a step of the chain
    from its state, the initial state, what the spec runs)."""
    b, _, nq, hd = q.shape
    d = h * hd

    def token(x):  # head-major (B, H, N, hd) -> token-major (B, N, H*hd)
        return x.transpose(1, 2).reshape(b, -1, d)

    def heads(x):
        return x.view(b, -1, h, hd).transpose(1, 2)

    if sp["kind"] == "head_major":
        if sp["variant"] is None:
            call, what = (lambda qq: fa.flash_attention_head_major(qq, k, v)[0]), "K7"
        else:
            call = lambda qq: fa.flash_attention_head_major_variant(qq, k, v, sp["variant"])[0]  # noqa: E731
            what = f"K7' {sp['variant']}"
        return call, call, q.contiguous(), what
    if sp["kind"] == "xln":
        kt, vt = token(k), token(v)
        call = lambda qq: fa.flash_cross_attention(qq, kt, vt, h)[0]  # noqa: E731
        return (lambda qq: heads(call(qq))), call, token(q), "K3"
    if k.shape[2] != nq:
        raise ValueError(f"{sp['name']}: the qkv specs need the backbone shape (Nq == Nk)")
    if sp["probe"]:
        fn, what = (lambda x: fa.flash_qkv_self_attention_probe(x, h, sp["probe"])[0]), f"K11 probe {sp['probe']}"
    elif sp["chunks"] > 1:
        fn, what = (lambda x: fa.flash_qkv_self_attention_chunked(x, h, sp["chunks"])[0]), \
            f"K11 chunks {sp['chunks']} ({len(fa.chunk_bounds(nq, sp['chunks'])) - 1} at N {nq})"
    else:
        fn, what = (lambda x: fa.flash_qkv_self_attention(x, h)[0]), "K1"

    def step(buf):  # the output becomes the next call's q section, in place
        buf[..., :d].copy_(fn(buf))
        return buf

    qkv = torch.cat([token(t) for t in (q, k, v)], -1)
    return (lambda x: heads(fn(x))), step, qkv, what + ", incl. the o -> q copy"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("specs", nargs="*", default=["v1:688,1408,2", "v2:688,1408,2", "v2bf16:688,1408,2"])
    ap.add_argument("--cpu", action="store_true", help="run the plain versions on the CPU at small shapes")
    ap.add_argument("--decoder", action="store_true", default=bool(os.environ.get("ATTN_BENCH_DEC")),
                    help="the decoder's cross-attention shape (default: ATTN_BENCH_DEC)")
    ap.add_argument("--layers", type=int, default=int(os.environ.get("ATTN_BENCH_LAYERS", "0")) or None,
                    help="calls per timed run (default: ATTN_BENCH_LAYERS, else 12 / 4)")
    ap.add_argument("--reps", type=int, default=5, help="timed runs per spec, at least 5")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.reps < 5:
        ap.error("--reps must be at least 5")
    try:
        specs = [parse_spec(s) for s in args.specs]
    except ValueError as e:
        ap.error(str(e))
    device = resolve_device(args.cpu)
    if device is None:
        return 1
    shape_name = "decoder" if args.decoder else "backbone"
    b, h, nq, nk, hd = (CPU_SHAPES if args.cpu else SHAPES)[shape_name]
    layers = args.layers or (12 if nq == nk else 4)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    q, k, v = (torch.randn(b, h, n, hd, generator=gen, device=device).to(torch.bfloat16) for n in (nq, nk, nk))
    flops = 4.0 * b * h * nq * nk * hd
    print(device_line(device))
    print(f"shape: {shape_name} B={b} H={h} Nq={nq} Nk={nk} hd={hd} bf16, {layers} chained layers per run, "
          f"median of {args.reps} runs, seed {args.seed}", flush=True)
    ref = None
    for sp in specs:
        once, step, state, what = _runner(sp, q, k, v, h)
        out = once(state.clone())
        wrong_math = sp["probe"] is not None or sp["variant"] in ("noexp", "mxuprobe")
        if ref is None and not wrong_math:
            ref = out
        diff = "PROBE(wrong math)" if wrong_math else f"maxdiff={float((out.float() - ref.float()).abs().max()):.4f}"

        def run(s=state, st=step):
            x = s
            for _ in range(layers):
                x = st(x)

        ms = median_ms(run, device, args.reps)
        ms_layer = ms / layers
        unit = "TFLOP/s" if device.type == "cuda" else "TFLOP/s (host)"
        unused = ", ".join(f"{n}={val}" for n, val in sp["tiles"].items())
        print(f"{sp['spec']:24s} "
              f"{ms_layer:8.3f} ms/layer {flops / (ms_layer / 1e3) / 1e12:7.1f} {unit}  {diff}  "
              f"[{what}; unused TPU tiles: {unused}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
