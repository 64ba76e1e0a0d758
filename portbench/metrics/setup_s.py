"""``setup_s``: seconds from the first line of ``run.py`` to the start of
the measured window: the imports, the CUDA context, the operands drawn
from the seed, the program's set-up (its encode) and the warm-up
epochs."""


def read(record):
    return record["setup_s"]
