"""joinbench: the benchmark of radixjoin_tpu_torch on the CUDA card.

``python3 joinbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``; see ``run.py``.
"""
