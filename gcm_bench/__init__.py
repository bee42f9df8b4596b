"""The benchmark of ``gcm_tpu_torch``, the PyTorch and CUDA port: one cell a
run, ``python -m gcm_bench.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>``. See ``run.py`` and ``PERF.md``."""
