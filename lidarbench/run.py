"""One run of one benchmark cell on the card.

    python3 -m lidarbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the correctness numbers, each beside its limit, as the last lines
of standard error, and one JSON object as the last line of standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` a ``breakdown``, for an open loop
``schedule_offset_ms`` (the program's first publication after the loop's
start, counted in ``setup_s``) and ``latency_ms`` (``p50`` and ``p95``
over every frame of the window; not metrics), and last ``checks``.
Without a CUDA card, or with fewer cards than the cell asks for, or with
JAX or the JAX package loaded, it exits non-zero and prints no result.
"""

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

_CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "build", "lidarbench-cache")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m lidarbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # kernel caches at fixed paths inside the checkout; keep libraries
    # from loading JAX on their own
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(_CACHE, sub)
    os.environ["USE_FLAX"] = "0"

    from .spec import Spec
    spec = Spec()
    chips = int(spec.workload(args.workload)["chips"])

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"lidarbench: the cell needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2

    from .harness import ForbiddenImport, run_cell
    try:
        res = run_cell(spec, args.workload, args.seed, args.seconds,
                       bool(args.trace), _T_START, chips=chips)
    except ForbiddenImport as e:
        print(f"lidarbench: {e}", file=sys.stderr)
        return 3
    return emit(res)


def emit(res) -> int:
    """Print the set-up's phases and the check's lines to standard error
    and the result line to standard output; nothing, and 3, where JAX or
    the JAX package has been loaded by then (by the program, the check
    or a metric's reader)."""
    from .harness import ForbiddenImport, assert_no_jax
    try:
        assert_no_jax("before the result")
    except ForbiddenImport as e:
        print(f"lidarbench: {e}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    print("setup " + " ".join(f"{k} {v:.3f}s" for k, v in
                              res.setup_phases.items()), file=sys.stderr)
    for line in res.check_lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res.line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
