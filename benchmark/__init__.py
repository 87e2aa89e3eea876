"""The benchmark of ``oscen_tpu_torch``, the PyTorch and CUDA port, on an
NVIDIA H100: ``python3 -m benchmark.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell of ``BENCHMARK.json`` once.

Data, found by name: ``configs/<config>.json`` (a configuration as run,
with its patch and the check's limits), ``traffic/<mix>.json`` (read by the
one generator, :mod:`traffic`), ``metrics/<metric>.py`` (a per-layer
reader each); the plain reference of each configuration is
``reference/<name>.py``, which imports nothing of the program.
"""
