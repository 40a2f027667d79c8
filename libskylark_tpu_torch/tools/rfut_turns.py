"""Time the rfut kernels of two checkouts of this repo in turns on one
CUDA card, so that a change is compared with its parent in one run.

    python3 libskylark_tpu_torch/tools/rfut_turns.py PARENT_DIR CHANGE_DIR

Each turn is a process of its own that imports ``libskylark_tpu_torch``
from one checkout (so that checkout's kernels are built into its own
``build/``) and times, with CUDA events, ``rfut_rowwise`` on 2^25 f32
elements of x at NB = 128, 256, 512 and 1024 and at 131072 x 4096, and
``rfut_rowwise_sampled`` at 131072 x 4096 -> 1024, each first held to
relative 1e-5 of its plain version.  The turns run parent, change,
change, parent on the same seeded inputs; a checkout's time is the mean
of its two turns' medians.  Only the Python wrappers are called, so any
two checkouts whose wrappers take ``(x, d, nb)`` and ``(x, d, nb, idx)``
compare.  Prints the card's name and power limit, then one line per
shape: both times, the change's time over the parent's, and each as a
share of the shape's bytes bound.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

MEM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
SPIN_CYCLES = 4_000_000        # ~2 ms of GPU clock: covers a call's host overhead
SEED = 20261017


def _time_ms(torch, fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of ``fn``, CUDA events, a spin kernel queued
    before each start event to cover the host's enqueue."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _worker(root: str) -> None:
    """One turn: time this checkout's kernels; prints a JSON line
    ``{shape: [ms, bytes]}``."""
    sys.path.insert(0, root)
    import torch

    from libskylark_tpu_torch.sketch import kernels_fut as kf

    g = torch.Generator(device="cuda").manual_seed(SEED)

    def signs(n):
        return torch.where(torch.randn(n, generator=g, device="cuda") > 0, 1.0, -1.0)

    def held(name, out, ref):
        rel = float((out - ref).abs().max() / ref.abs().max())
        if not rel <= 1e-5:
            raise SystemExit(f"{name}: rel {rel} against the plain version (tol 1e-5)")

    res = {}
    for m, nb in [((1 << 25) // nb, nb) for nb in (128, 256, 512, 1024)] + [(131072, 4096)]:
        x, d = torch.randn(m, nb, generator=g, device="cuda"), signs(nb)
        name = f"rfut_rowwise x {m} x {nb} f32, NB = {nb}"
        held(name, kf.rfut_rowwise(x, d, nb), kf.rfut_rowwise_plain(x, d, nb))
        res[name] = [_time_ms(torch, lambda: kf.rfut_rowwise(x, d, nb)), 4 * (2 * m * nb + nb)]
    # The sampled variant on the last shape's x and d (131072 x 4096).
    idx = torch.randint(0, nb, (1024,), generator=g, device="cuda", dtype=torch.int32)
    name = f"rfut_rowwise_sampled x {m} x {nb} f32, NB = {nb}, S = 1024"
    held(name, kf.rfut_rowwise_sampled(x, d, nb, idx), kf.rfut_rowwise_sampled_plain(x, d, nb, idx))
    res[name] = [_time_ms(torch, lambda: kf.rfut_rowwise_sampled(x, d, nb, idx)),
                 4 * (m * nb + nb + m * 1024 + 1024)]
    print(json.dumps(res))


def _turn(root: Path) -> dict:
    done = subprocess.run([sys.executable, __file__, "--worker", str(root)],
                          capture_output=True, text=True, timeout=900)
    if done.returncode:
        raise SystemExit(f"turn in {root} failed ({done.returncode}):\n{done.stderr[-4000:]}")
    return json.loads(done.stdout.strip().splitlines()[-1])


def main(parent: Path, change: Path) -> None:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    p1, c1, c2, p2 = (_turn(root) for root in (parent, change, change, parent))
    for name, (_, nbytes) in c1.items():
        b_ms = nbytes / MEM_BYTES_PER_S * 1e3
        p_ms = (p1[name][0] + p2[name][0]) / 2
        c_ms = (c1[name][0] + c2[name][0]) / 2
        print(f"{name}: change {c_ms!r} ms ({b_ms / c_ms:.3f} of the bytes bound "
              f"{b_ms:.4f} ms), parent {p_ms!r} ms ({b_ms / p_ms:.3f}), change / parent "
              f"{c_ms / p_ms:.3f}; turns parent {p1[name][0]!r}, {p2[name][0]!r}, change "
              f"{c1[name][0]!r}, {c2[name][0]!r} [{card}]")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        _worker(sys.argv[2])
    else:
        main(*(Path(a).resolve() for a in sys.argv[1:3]))
