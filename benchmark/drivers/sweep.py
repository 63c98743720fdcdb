"""The preflop sweep on K2 (``ops/cuda_equity.equity_sweep_kernel``).

A request is the 169 canonical starting hands (``canonical_hands``), each
against a random hand over ``rollouts`` rollouts, in one launch with a
Philox seed drawn from the run's seed and the request's index; the
equities come back to the host.

The check, after the window: ``check_hands`` hands, drawn from the run's
seed, of each of two requests (``tables.checked_requests``), against the
plain reference (``mcref.equity``);
``count_gap`` is the largest gap in twice the wins plus the ties, which
the equity ``(wins + ties / 2) / rollouts`` gives back exactly.
``check(control=True)`` puts the reference's control (16-bit draws) in
the program's place. Work: rollouts.
"""

from __future__ import annotations

import numpy as np

from mcbench import base, seeds, tables

MAIN_KERNEL = "mc_sweep_kernel"


def canonical_hands():
    """[169, 2] card ids (suit * 13 + rank - 2): for each high rank from
    ace down and each low rank from it down, the pair (spades, hearts),
    or the suited (both spades) then the offsuit (spades, hearts) hand."""
    out = []
    for hi in range(12, -1, -1):
        for lo in range(hi, -1, -1):
            if hi == lo:
                out.append((hi, 13 + lo))
            else:
                out += [(hi, lo), (hi, 13 + lo)]
    return np.array(out, np.int64)


class Driver(base.Base):
    def __init__(self, config, traffic, device, seed):
        from montecarlo_tpu_torch.ops import cuda_equity
        self.eq = cuda_equity
        super().__init__(device, seed)
        self.traffic = traffic
        self.n = int(traffic["rollouts"])
        self.heroes = canonical_hands()
        self.answers = []

    def _run(self, key):
        with self.span("req.sweep"):
            eq, _ = self.eq.equity_sweep_kernel(
                seeds.kernel_seed(self.seed, "request", key), self.heroes,
                self.n, self.device)
        return eq

    def request(self, i):
        self.answers.append(self._run(i))
        self.n_answered += 1
        return {"rollouts": self.n * len(self.heroes)}

    def picks(self):
        g = seeds.rng(self.seed, "check")
        return [(i, h) for i in tables.checked_requests(self.seed,
                                                        self.n_answered)
                for h in g.choice(len(self.heroes),
                                  self.traffic["check_hands"], replace=False)]

    def check(self, control=False):
        from mcref.equity import sweep_counts
        gap = 0
        for i, h in self.picks():
            s = seeds.kernel_seed(self.seed, "request", i)
            w, t = sweep_counts(s, self.heroes.tolist(), int(h), self.n,
                                self.device)
            if control:
                cw, ct = sweep_counts(s, self.heroes.tolist(), int(h),
                                      self.n, self.device, draw_bits=16)
                got = 2 * cw + ct
            else:
                got = int(np.rint(self.answers[i][h] * 2 * self.n))
            gap = max(gap, abs(got - (2 * w + t)))
        return [("count_gap", float(gap),
                 float(self.traffic["limits"]["count_gap"]))]
