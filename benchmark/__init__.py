"""The benchmark of ``midvision_probe_torch`` on one NVIDIA H100.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Configurations (``configs/``), traffic mixes (``traffic/``),
the loops that the mixes name (``loops/``), per-layer metrics
(``metrics/``) and the comparison limits of each cell (``limits/``) are
files of their own, found by name.
"""
