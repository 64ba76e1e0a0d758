"""``setup_s``: seconds of the run's set-up that the benchmark and the
program own: from the moment ``import torch`` has returned and card 0's
CUDA context has been made (torch's ``torch.cuda.init`` included) to
the start of the measured window. That is the port's import, the inputs
drawn from the seed, the program's set-up (its encode, its kernels
built or loaded) and the warm-up epochs: every part of ``setup_parts``
but ``harness.OUTSIDE_SETUP`` (the interpreter's start, torch's import,
the context and torch's start on it, which no change to the benchmark
or the program can move)."""

from portbench import harness


def read(record):
    return sum(s for name, s in record["setup_parts"].items()
               if name not in harness.OUTSIDE_SETUP)
