"""The benchmark of ``tpu_sdr_torch``, the PyTorch and CUDA spectrum analyzer.

``python -m sdrbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` on one card and prints one JSON line.
Everything that belongs to one configuration, traffic mix, entry, metric or
cell is a file of its own that the harness finds by its name (``spec.py``).
"""
