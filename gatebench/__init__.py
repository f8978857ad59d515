"""gatebench: the benchmark of ``mlis_tpu_torch``'s semantic gate on one H100.

``python3 -m gatebench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once; see
``gatebench/README.md``.
"""
