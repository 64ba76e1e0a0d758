"""The benchmark of the PyTorch and CUDA port (``mpistragglers_jl_tpu_torch``).

One command runs one cell of ``BENCHMARK.json`` on the card it is
started on and prints one JSON line:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Driven by data: a cell names a configuration (``configs/<name>.json``,
which names its driver, ``drivers/<driver>.py``) and a traffic mix
(``traffic/<name>.json``); each metric is read by
``metrics/<name>.py``. The yardstick lives here: the generator, the
trace reading, the bounds and peaks, and the plain reference.
"""
