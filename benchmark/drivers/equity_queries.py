"""Heads-up equity queries on K1, through the port's documented entry
``rollout.equity.equity_vs_hand``.

A request is the traffic's ``matchups`` asked one after the other, as a
user asks them: each is hero holes against villain holes on a known board
of 0, 3 or 4 cards, over ``rollouts`` rollouts, with a Philox seed of its
own drawn from the run's seed, the request's index and the matchup's; its
answer (wins, ties, losses, the equity and its 95% interval) is on the
host before the next is asked. Cards are written as [suit 0..3, rank
2..14], as the README's ``make_card`` takes them; their ids are
``suit * 13 + rank - 2``. Every request of every seed is the same work.

The check, after the window: ``check`` (request, matchup) pairs drawn
from the run's seed among every one answered, the last answered among
them, recounted by the plain reference (``mcref.equity``); ``count_gap``
is the largest gap in wins plus ties. ``check(control=True)`` puts the
reference's control (16-bit draws) in the program's place. Work: queries,
rollouts, and rollouts by the number of board cards drawn (5, 2 or 1).
"""

from __future__ import annotations

from mcbench import base, seeds

MAIN_KERNEL = "mc_equity_kernel"


def card_ids(cards) -> list:
    """Card ids of [suit, rank] pairs."""
    return [int(s) * 13 + int(r) - 2 for s, r in cards]


def matchups(traffic) -> list:
    """[(hero ids, villain ids, board ids)] of the traffic, in order."""
    return [tuple(card_ids(m[k]) for k in ("hero", "villain", "board"))
            for m in traffic["matchups"]]


def query_seed(seed: int, i, j: int) -> int:
    """The Philox seed of matchup ``j`` of request ``i``."""
    return seeds.kernel_seed(seed, "request", i, j)


class Driver(base.Base):
    def __init__(self, config, traffic, device, seed):
        from montecarlo_tpu_torch.rollout import equity
        self.equity = equity
        super().__init__(device, seed)
        self.traffic = traffic
        self.n = int(traffic["rollouts"])
        self.queries = matchups(traffic)
        self.answers = []

    def _run(self, key):
        out = []
        for j, (hero, villain, board) in enumerate(self.queries):
            with self.span("req.query"):
                res = self.equity.equity_vs_hand(
                    query_seed(self.seed, key, j), hero, villain, self.n,
                    board, self.device)
                out.append((res.wins, res.ties, res.ci95))
        return out

    def request(self, i):
        self.answers.append([(w, t) for w, t, _ in self._run(i)])
        self.n_answered += 1
        work = {"queries": len(self.queries),
                "rollouts": self.n * len(self.queries)}
        for _, _, board in self.queries:
            key = f"rollouts_draw{5 - len(board)}"
            work[key] = work.get(key, 0) + self.n
        return work

    def picks(self) -> list:
        """The (request, matchup) pairs the check compares."""
        m = len(self.queries)
        total = self.n_answered * m
        if total < 1:
            raise RuntimeError("no request answered")
        g = seeds.rng(self.seed, "check")
        k = min(int(self.traffic["check"]), total)
        flat = set(g.choice(total, k, replace=False).tolist()) | {total - 1}
        return [divmod(x, m) for x in sorted(flat)]

    def check(self, control=False):
        from mcref.equity import matchup_counts
        gap = 0
        for i, j in self.picks():
            hero, villain, board = self.queries[j]
            args = (query_seed(self.seed, i, j), hero, villain, board,
                    self.n, self.device)
            w, t = matchup_counts(*args)
            got = matchup_counts(*args, draw_bits=16) if control \
                else self.answers[i][j]
            gap = max(gap, abs(int(got[0]) - w) + abs(int(got[1]) - t))
        return [("count_gap", float(gap),
                 float(self.traffic["limits"]["count_gap"]))]
