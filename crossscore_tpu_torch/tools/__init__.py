"""Command-line microbenchmarks of the port's kernels and timing instruments
(K2, K4, K7', K11, K12), each the counterpart of a TPU tool under
``tools/``; run as ``python -m crossscore_tpu_torch.tools.<name>``."""
