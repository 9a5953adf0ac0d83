"""The benchmark of the PyTorch/CUDA port (``admm_tpu_torch``) on one GPU.

``python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything that belongs to one configuration, traffic mix,
entry point, per-layer metric or kernel sits in a file of its own, found
by the name that ``BENCHMARK.json`` gives (:mod:`port_bench.registry`).
"""
