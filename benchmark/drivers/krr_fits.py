"""Random-feature kernel ridge traffic: back-to-back fits of
``streaming_kernel_ridge`` over an X held on the card, each fit on a
context advanced from the last (new features, as a refit or a
hyperparameter search draws them).

Inputs, from the seed on the card: X (n, d) bf16 standard normal, made
panel by panel; labels ±1.  ``block_fn`` returns a panel of the resident
X; nothing is generated or copied in the window.

Correctness: a fit's W is held against the float64 ridge solution of
the configuration's bf16 features, rebuilt by the reference from the
counter stream: ``w_gap = ‖W − W*‖ / ‖W*‖`` over a sample of the
window's fits drawn from the seed.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import kernel_ridge as ref


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.cfg, self.mix, self.seed, self.device = config, traffic, int(seed), device
        self.n, self.d = int(config["rows"]), int(config["dim"])
        self.s, self.rows = int(config["features"]), int(config["block_rows"])
        if self.n % self.rows:
            raise ValueError("rows must be a whole number of panels")
        self.calls = 0
        self.timer = None

    def setup(self) -> None:
        from libskylark_tpu_torch.core.context import SketchContext
        from libskylark_tpu_torch.ml import GaussianKernel, KrrParams, streaming_kernel_ridge

        g = torch.Generator(device=self.device)
        g.manual_seed(self.seed)
        nb = self.n // self.rows
        self.X = torch.empty((nb, self.rows, self.d), dtype=torch.bfloat16, device=self.device)
        for p in range(nb):
            self.X[p].normal_(generator=g)
        r = torch.randn(self.n, generator=g, device=self.device, dtype=torch.float32)
        self.y = torch.where(r >= 0, 1.0, -1.0).to(torch.float32)
        del r
        self.ctx = SketchContext(seed=self.seed)
        self.kernel = GaussianKernel(self.d, float(self.cfg["sigma"]))
        self.params = KrrParams(max_split=int(self.cfg["max_split"]),
                                iter_lim=int(self.mix["sweeps"]),
                                tolerance=float(self.mix["tolerance"]))
        self._fit = streaming_kernel_ridge
        for i in range(int(self.mix["warmup"])):
            self.request(i)

    def _block(self, start: int, rows: int):
        return self.X[start // rows]

    def request(self, i: int) -> dict:
        call = self.calls
        self.calls += 1
        model = self._fit(self.kernel, self._block, (self.n, self.d), self.y,
                          float(self.cfg["lam"]), self.s, self.ctx, self.params,
                          block_rows=self.rows, feature_dtype=torch.bfloat16, timer=self.timer)
        return {"W": model.W, "call": call}

    def begin_window(self) -> None:
        from libskylark_tpu_torch.utils import PhaseTimer

        self.timer = PhaseTimer()

    def info_lines(self, window) -> list[str]:
        return [f"fits {window.count}",
                f"phases {dict(self.timer.totals)} counts {dict(self.timer.counts)}"]

    def release(self) -> None:
        self.ctx = self.kernel = self._fit = None

    def _reference(self, call: int, round_cos=None):
        """W* of fit ``call``: its map reserves d·S normals and S shifts
        on the shared context, in that order (one feature chunk)."""
        base = call * (self.d * self.s + self.s)
        W, shifts = ref.rft_draws(self.seed, base, self.d, self.s, float(self.cfg["sigma"]),
                                  self.device)
        ys = self.y.reshape(self.X.shape[0], self.rows)
        return ref.solve(self.X, ys, W, shifts, self.s, float(self.cfg["lam"]), round_cos)

    def gaps(self, records: list, rng, control: bool = False) -> list[float]:
        ok = [r for r in records if "error" not in r]
        out = []
        for r in rng.sample(ok, min(len(ok), int(self.mix["check_sample"]))):
            Wr = self._reference(r["call"])
            W = self._reference(r["call"], ref.round_e4m3) if control else r["W"].double()
            out.append(float(torch.linalg.vector_norm(W - Wr) / torch.linalg.vector_norm(Wr)))
        return out

    def check(self, records: list, rng) -> list[dict]:
        gaps = self.last_gaps = self.gaps(records, rng)
        return [{"name": "w_gap", "value": max(gaps) if gaps else math.inf,
                 "limit": float(self.mix["limits"]["w_gap"])}]
