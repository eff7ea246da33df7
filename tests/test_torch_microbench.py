"""The port's microbenchmark entry points (``crossscore_tpu_torch.tools``):
each runs with ``--cpu`` (the plain versions at small shapes) as a
subprocess and exits 0 with its timed lines, and without ``--cpu`` on a
machine with no card exits 1; the attention tool keeps the TPU tool's spec
grammar."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from crossscore_tpu_torch.tools import attn_microbench, bwd_microbench, lane_pad_probe

ROOT = Path(__file__).resolve().parent.parent


def _run(*args):
    return subprocess.run([sys.executable, "-m", *args], cwd=ROOT, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("args,lines", [
    (["crossscore_tpu_torch.tools.attn_microbench", "--cpu", "--layers", "2", "qkv:688,2", "qkvc:688,2,3",
      "qkvp:688,2,nomax", "qkvp:688,2,nosum", "qkvp:688,2,mxu", "v1:688,1408,2", "xln:512,1024"], 7),
    (["crossscore_tpu_torch.tools.attn_microbench", "--cpu", "--decoder", "--layers", "2", "v2:1,1024,1",
      "v2noaug:1,1024,1", "v2bf16:1,1024,1", "v2noexp:1,1024,1", "v2mxu:1,1024,1"], 5),
    (["crossscore_tpu_torch.tools.lane_pad_probe", "--cpu", "--reps", "5", "--step-ms", "98"], 6),
    (["crossscore_tpu_torch.tools.bwd_microbench", "--cpu"], len(bwd_microbench.CONFIGS))])
def test_tool_runs_on_the_cpu(args, lines):
    res = _run(*args)
    assert res.returncode == 0, res.stdout + res.stderr
    out = res.stdout.splitlines()
    assert out[0].startswith("device: cpu")
    timed = [line for line in out if " ms" in line and ("ms/layer" in line or "saving" in line or "TFLOP" in line)]
    assert len(timed) == lines, res.stdout
    if "attn_microbench" in args[0]:
        assert sum("PROBE(wrong math)" in line for line in out) == sum(
            a.startswith(("qkvp", "v2noexp", "v2mxu")) for a in args)
        assert "maxdiff=0.0000" in out[2]  # the first spec against itself


@pytest.mark.parametrize("tool", [attn_microbench, lane_pad_probe, bwd_microbench])
def test_tool_without_cpu_needs_a_card(tool, capsys):
    """``main`` is the exit code of ``python -m``: 1, with a message, when
    there is no card and ``--cpu`` was not given."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the tool would run on it")
    assert tool.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("spec,want", [
    ("v2bf16:688,1408,2", {"kind": "head_major", "variant": "bf16exp", "chunks": 1}),
    ("v2noaug:688,1408,2", {"kind": "head_major", "variant": None}),
    ("qkv:688,2", {"kind": "qkv", "chunks": 1, "probe": None}),
    ("qkv:688,2,3", {"kind": "qkv", "chunks": 3}),
    ("qkvc:688,2,2", {"kind": "qkv", "chunks": 2}),
    ("qkvp:688,2,nosum", {"kind": "qkv", "probe": "nosum", "tiles": {"block_q": 688, "hpack": 2}}),
    ("xln:512,1024", {"kind": "xln", "tiles": {"block_q": 512, "block_k": 1024}})])
def test_spec_grammar(spec, want):
    got = attn_microbench.parse_spec(spec)
    assert {k: got[k] for k in want} == want


@pytest.mark.parametrize("spec,match", [("qkv:688,2,1,allpar", "Mosaic"), ("v3:1,2,3", "unknown"),
                                        ("qkvp:688,2,nosoftmax", "probe"), ("qkvc:688,2", "chunks"),
                                        ("v2:688,1408", "block_h")])
def test_spec_refusals(spec, match):
    with pytest.raises(ValueError, match=match):
        attn_microbench.parse_spec(spec)
