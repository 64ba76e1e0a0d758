"""Run one cell of the port's benchmark on the card it is started on.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``,
``portbench/`` and the port (``mpistragglers_jl_tpu_torch``). Prints the
numbers compared beside their limits as the last lines of standard
error, and one JSON line as the last line of standard output. Exits
with 2, printing no result, without a CUDA card or with fewer cards
than the cell asks for, and with 3 if a module of JAX or of the JAX
package was loaded. ``--control <name>`` runs the lower-precision
control of the correctness check that the cell's configuration states
(``control`` in its file: ``tf32`` for an f32 one, for example), which
must come out not correct; the names a driver takes are its
``CONTROLS``.

``setup_s`` is the set-up less torch's import and card 0's CUDA context
(made on a thread beside the import, then torch's ``torch.cuda.init``
on it): what the benchmark and the program do from then to the start of
the window. Every part is printed.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache of the program at a fixed path in the
# checkout (the coded-GEMM path builds nothing; this is for what may),
# Python's compiled modules too: under PYTHONDONTWRITEBYTECODE, with no
# compiled torch installed, every run compiled torch's modules anew;
# here only a checkout's first run does
_CACHE = os.path.join(ROOT, ".portbench_cache")
sys.pycache_prefix = os.path.join(_CACHE, "pycache")
sys.dont_write_bytecode = False

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import threading  # noqa: E402

os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, ROOT)


def _card() -> str:
    """``nvidia-smi``'s name and power limit of the card, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
        return out[0] if out else "nvidia-smi printed nothing"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def _primary_context() -> None:
    """Make card 0's primary CUDA context through the driver API
    (``cuInit``, ``cuDevicePrimaryCtxRetain``): run on a thread while the
    main thread imports torch, whose runtime then finds the context made.
    Without a driver it does nothing: the check for a card comes later."""
    import ctypes

    try:
        cuda = ctypes.CDLL("libcuda.so.1")
    except OSError:
        return
    dev, ctx = ctypes.c_int(), ctypes.c_void_p()
    if (cuda.cuInit(0) == 0
            and cuda.cuDeviceGet(ctypes.byref(dev), 0) == 0):
        cuda.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default=None)
    args = ap.parse_args(argv)
    marks = [("python and argparse", time.perf_counter())]
    # the CUDA context, which costs the host 0.4-8 s, made beside the
    # import of torch, which costs it 4-6 s
    context = threading.Thread(target=_primary_context, daemon=True)
    context.start()

    import torch

    marks.append(("import torch", time.perf_counter()))
    context.join()
    marks.append(("CUDA context", time.perf_counter()))
    import mpistragglers_jl_tpu_torch  # noqa: F401  (absent: no run)

    from portbench import harness

    chips = int(harness.cell(ROOT, args.workload).entry["chips"])
    marks.append(("port import", time.perf_counter()))

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA card(s), this "
              f"machine has {n}", file=sys.stderr)
        return 2
    # torch's own start on the made context
    torch.cuda.init()
    marks.append(("CUDA init", time.perf_counter()))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result, worst = harness.run_cell(
        ROOT, args.workload, seed=args.seed, seconds=args.seconds,
        trace=bool(args.trace), device=torch.device("cuda", 0),
        t_start=T_START, control=args.control, marks=marks)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: JAX or the JAX package was loaded: {found}",
              file=sys.stderr)
        return 3
    card = _card()
    print(f"card: {card}", file=sys.stderr)
    parts = result.pop("setup_parts")
    print("set-up seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                         parts.items()), file=sys.stderr)
    cpu = result.pop("setup_cpu_s")
    print("set-up cpu seconds (the process's threads): " + ", ".join(
        f"{k} {v:.3f}" for k, v in cpu.items()), file=sys.stderr)
    held = result.pop("memory_check_bytes")
    print(f"memory peak: program {result['device']['memory_peak_bytes']} "
          f"bytes, the check {held} bytes more", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    for name, (value, limit) in worst.items():
        print(f"check {name}: {value!r} limit {limit!r}", file=sys.stderr)
    checks = result.pop("checks")
    result["card"] = card
    result["checks"] = checks  # the compared numbers come last
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
