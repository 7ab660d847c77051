"""Count the torch.profiler windows of short launches that lose device
events, with and without the idle padding of ``profiling.profile_window``.

    python -m fastdem_tpu_torch.tools.profiler_windows [--seconds 240] [--reps 50]

Alternates unpadded and padded windows (``profiling.PROFILE_PAD_S`` at each
end) of ``--reps`` in-place adds on a 22,500-element tensor, about the
length of a K4 launch on the flagship map, until ``--seconds`` have passed.
Prints one line per window that recorded fewer device events than launches,
then one JSON object: the windows, the empty ones and the partial ones for
each padding, with the card's name and power limit. Runs on the card only.
"""

import argparse
import json
import time

import torch

from fastdem_tpu_torch.utils import profiling


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=240.0)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profiler_windows: no CUDA device")
    x = torch.zeros(22500, device="cuda")
    pads = (0.0, profiling.PROFILE_PAD_S)
    stats = {pad: {"windows": 0, "empty": 0, "partial": 0} for pad in pads}
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < args.seconds:
        pad = pads[i % 2]
        _, events = profiling.profile_window(lambda: x.add_(1.0), args.reps, pad)
        n = sum(k for k, _ in events.values())
        s = stats[pad]
        s["windows"] += 1
        if n < args.reps:
            s["empty" if n == 0 else "partial"] += 1
            print(f"window {i}, padding {pad} s: {n} of {args.reps} device events "
                  f"at {time.perf_counter() - t0:.1f} s", flush=True)
        i += 1
    print(json.dumps({"reps": args.reps,
                      "padding_s": {str(pad): s for pad, s in stats.items()},
                      "platform": profiling.platform_info()}))


if __name__ == "__main__":
    main()
