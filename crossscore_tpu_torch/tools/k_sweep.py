"""The neighbour-count sweep (BASELINE config #4): the test CLI at K = 4, 8
and 16 cross-references; the port's counterpart of ``tools/k_sweep.sh``.

    python -m crossscore_tpu_torch.tools.k_sweep <dataset_root> [ckpt] [overrides...]

``ckpt`` (a Lightning ``.ckpt`` or a train run's ``ckpt/`` dir; ``null`` or
left out for the seeded weights) goes to ``trainer.ckpt_path_to_load``; the
overrides go to every run (``trainer.accelerator=cpu`` on the CPU). Each run
is ``tasks.test`` with ``alias=K<K>``, in this process; after the runs one
line a K gives its batches, its output dir and the ``mean`` row of its
``metrics.csv``.
"""

from __future__ import annotations

import csv
import sys
from pathlib import Path

KS = (4, 8, 16)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0].startswith("-"):
        print("usage: python -m crossscore_tpu_torch.tools.k_sweep <dataset_root> [ckpt] [overrides...]",
              file=sys.stderr)
        return 2
    data_root = argv[0]
    ckpt = argv[1] if len(argv) > 1 and "=" not in argv[1] else "null"
    extra = argv[2:] if len(argv) > 1 and "=" not in argv[1] else argv[1:]

    from crossscore_tpu_torch.tasks.test import main as test_main

    done = []
    for k in KS:
        out_dir = Path(test_main([f"data.dataset.path=[{data_root}]", f"trainer.ckpt_path_to_load={ckpt}",
                                  f"data.neighbour_config.cross={k}", f"alias=K{k}"] + extra))
        with open(out_dir / "metrics.csv") as f:
            rows = list(csv.DictReader(f))
        done.append((k, len(rows) - 1, out_dir, rows[-1]))
    for k, n, out_dir, mean in done:
        print(f"k_sweep K={k}: {n} batches -> {out_dir}; "
              + ", ".join(f"{name} {value}" for name, value in mean.items() if name != "batch_idx"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
