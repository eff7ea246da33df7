"""Command-line tools of the port, each the counterpart of a TPU tool under
``tools/`` of the same name: microbenchmarks of its kernels and timing
instruments (K2, K4, K7', K11, K12), the profiling tools (``model_breakdown``,
``trace_breakdown``, ``trace_events``, ``train_trace``, ``h2d_probe``,
``train_microbench``), the build-flag sweep (``xla_flag_sweep``) and the
serving, ingest, ViT-L and quality tools; run as ``python -m
crossscore_tpu_torch.tools.<name>``."""
