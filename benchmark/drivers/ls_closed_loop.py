"""Least-squares traffic: one caller solving ``min ‖A x − b‖`` back to
back with ``approximate_least_squares``, cycling a pool of right-hand
sides, one sketch context shared by every call (so each solve draws a
new sketch, as a user's successive calls do).

Inputs, from the seed on the card: A and the pool of right-hand sides
b_k with independent standard normal entries, as libSkylark's
``examples/least_squares.cpp`` draws its problem.

Correctness: a solve is held against the float64 solution of the
problem it claims to solve, in that problem's own norm:
``gap = ‖M(x − x*)‖ / ‖c‖`` with (M, c) = (S·A, S·b) for sketch-and-
solve, S rebuilt by the reference from the counter stream, and (A, b)
for the routes that solve A itself.  ``solution_gap`` is the largest
gap over the solves compared: every solve of the window where the
reference factors A once, a sample drawn from the seed where each solve
has its own sketch.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import least_squares as ref

GOLDEN = 0x9E3779B9


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.cfg, self.mix, self.seed, self.device = config, traffic, int(seed), device
        self.m, self.n = int(config["rows"]), int(config["cols"])
        self.route = traffic["route"]
        self.stype = traffic["sketch_type"]
        self.s = int(traffic["sketch_size"])
        self.calls = 0

    # -- set-up ---------------------------------------------------------------

    def setup(self) -> None:
        from libskylark_tpu_torch.core.context import SketchContext
        from libskylark_tpu_torch.linalg.least_squares import (
            LeastSquaresParams, approximate_least_squares)

        dev = self.device
        g = torch.Generator(device=dev)
        g.manual_seed(self.seed)
        self.A = torch.randn(self.m, self.n, generator=g, device=dev, dtype=torch.float32)
        # (pool, m): each right-hand side contiguous.
        self.B = torch.randn(int(self.mix["pool"]), self.m, generator=g, device=dev,
                             dtype=torch.float32)
        self.ctx = SketchContext(seed=self.seed)
        self._solve = approximate_least_squares
        self.params = LeastSquaresParams(sketch_type=self.stype, sketch_size=self.s)
        for i in range(int(self.mix["warmup"])):
            self.request(i)

    def request(self, i: int) -> dict:
        k = i % self.B.shape[0]
        call = self.calls
        self.calls += 1
        x, info = self._solve(self.A, self.B[k], self.ctx, self.params, route=self.route,
                              return_info=True)
        return {"x": x, "info": info, "pool": k, "call": call}

    def begin_window(self) -> None:
        pass

    def info_lines(self, window) -> list[str]:
        from libskylark_tpu_torch.sketch import _launch

        counts = {f"{k[1]}" + ("" if k[2] is None else f"@{k[2]}"): v
                  for k, v in _launch.launch_counts().items() if v}
        return [f"solves {window.count}",
                f"launches {counts}"]

    def release(self) -> None:
        """Drop the program's state; A and the pool are the inputs."""
        self.ctx = self._solve = None

    # -- correctness ----------------------------------------------------------

    def _sketch_of(self, rec: dict):
        """(seed, counter base, size) of the sketch a sketch-and-solve used,
        by the counter contract: each call's first sketch is reserved on
        the shared context (N + S counters for the FJLT), a later rung of
        the guard's ladder on a fresh-seed context at counter 0, its size
        doubled from the second retry on."""
        attempts = rec["info"]["recovery"]["attempts"]
        i = len(attempts) - 1
        if attempts[-1]["action"] == "fallback":
            return None
        if i == 0:
            return self.seed, rec["call"] * (self.m + self.s), self.s
        seed = (self.seed ^ (GOLDEN * i)) % (2 ** 31 - 1)
        size = self.s
        for _ in range(2, i + 1):
            size = min(int(size * 2.0), self.m)
        return seed, 0, size

    def _whole_problem(self, round_input=None):
        R = ref.qr_augmented(self.A, self.B.T, round_input=round_input)
        return ref.solve_from_r(R, self.n)

    def _sketched_problem(self, key, k, round_input=None):
        seed, base, s = key
        SA = ref.fjlt_columnwise(self.A, seed, base, s, round_input=round_input)
        Sb = ref.fjlt_columnwise(self.B[k][:, None], seed, base, s, round_input=round_input)
        return SA, Sb

    def gaps(self, records: list, rng, control: bool = False) -> list[float]:
        """The gap of each compared solve; ``control`` replaces the
        program's x by the reference computed from inputs rounded to TF32
        (the precision below the configuration's float32)."""
        ok = [r for r in records if "error" not in r]
        if not ok:
            return []
        rnd = ref.round_tf32 if control else None
        if self.route == "sketch" and self.stype != "FJLT":
            raise ValueError(f"the reference has no {self.stype} sketch-and-solve")
        if self.route != "sketch":
            Xs, Ra = self._whole_problem()
            Xc = self._whole_problem(rnd)[0] if control else None
            norms = torch.linalg.vector_norm(self.B, dim=1, dtype=torch.float64)
            out = []
            for r in ok:
                x = Xc[:, r["pool"]] if control else r["x"].double()
                out.append(float(torch.linalg.vector_norm(Ra @ (x - Xs[:, r["pool"]]))
                                 / norms[r["pool"]]))
            return out
        picked = rng.sample(ok, min(len(ok), int(self.mix["check_sample"])))
        out = []
        whole = None
        for r in picked:
            key = self._sketch_of(r)
            if key is None:  # the dense fallback solved A itself
                whole = whole or self._whole_problem()
                x = r["x"].double()
                out.append(float(torch.linalg.vector_norm(whole[1] @ (x - whole[0][:, r["pool"]]))
                                 / torch.linalg.vector_norm(self.B[r["pool"]].double())))
                continue
            SA, Sb = self._sketched_problem(key, r["pool"])
            xs, Rs = ref.solve_from_r(ref.qr_augmented(SA, Sb), self.n)
            if control:
                SAc, Sbc = self._sketched_problem(key, r["pool"], rnd)
                x = ref.solve_from_r(ref.qr_augmented(SAc, Sbc), self.n)[0][:, 0]
            else:
                x = r["x"].double()
            out.append(float(torch.linalg.vector_norm(Rs @ (x - xs[:, 0]))
                             / torch.linalg.vector_norm(Sb)))
        return out

    def check(self, records: list, rng) -> list[dict]:
        gaps = self.last_gaps = self.gaps(records, rng)
        return [{"name": "solution_gap", "value": max(gaps) if gaps else math.inf,
                 "limit": float(self.mix["limits"]["solution_gap"])}]
