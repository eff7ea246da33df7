"""GT score summary CLI (parity with reference ``utils/evaluation/summarise_score_gt.py``);
the port's counterpart of ``crossscore_tpu/tasks/summarise_score_gt.py``.

    python -m crossscore_tpu_torch.tasks.summarise_score_gt --dir_in <res_dir> --dir_out <dir>

Reads every ``metric_map/{ssim,mae}`` pair under ``--dir_in`` (a
``<method>/<dataset>/res_*`` tree) and writes one per-frame CSV,
``<dir_out>/<dataset>/<method>.csv``, on the host: no device is used.
"""

from __future__ import annotations

from argparse import ArgumentParser

from crossscore_tpu_torch.io.summariser import SummaryWriterGroundTruth


def main(argv=None):
    ap = ArgumentParser(description="Summarise the ground truth results.")
    ap.add_argument("--dir_in", type=str, required=True)
    ap.add_argument("--dir_out", type=str, required=True)
    ap.add_argument("--fast_debug", type=int, default=-1)
    ap.add_argument("-n", "--num_workers", type=int, default=16)
    ap.add_argument("-f", "--force", action="store_true")
    args = ap.parse_args(argv)
    SummaryWriterGroundTruth(
        dir_in=args.dir_in,
        dir_out=args.dir_out,
        num_workers=args.num_workers,
        fast_debug=max(0, args.fast_debug),
        force=args.force,
    ).write_csv()


if __name__ == "__main__":
    main()
