"""What the engine cells' drivers share: the table configuration, the nets,
the sample of tables a check replays, the rows kept of each answer, and
``Engine``, the driver both build on.

The port's packed state is ``[blocks, F, 8, 128]`` int32, table ``t`` at
block ``t // 1024``, position ``t % 1024``. A request's answer is kept as
the rows of the sampled tables ([F, k]) and the sums of two rows over
every table (hands and overflowed tables), on the device, without a wait.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from mcbench import base, seeds, spec

PER_BLOCK = 1024


def table_config(config: dict):
    """The port's ``TableConfig`` of a configuration file."""
    from montecarlo_tpu_torch.engine.state import TableConfig
    return TableConfig(num_seats=config["seats"],
                       small_blind=config["small_blind"],
                       big_blind=config["big_blind"],
                       starting_stack=config["starting_stack"],
                       rules=config["rules"])


def load_net(config: dict, name: str, base: Path = spec.HERE):
    """The six float32 arrays (w1, b1, w2, b2, w3, b3) of net ``name``."""
    with np.load(base / config["nets"][name]) as z:
        return [np.asarray(z[f"p_{i}"], np.float32) for i in range(6)]


def sample_tables(seed: int, n_tables: int, k: int) -> np.ndarray:
    """``k`` distinct table indices, ascending, drawn from the run's
    seed."""
    g = seeds.rng(seed, "check", "tables")
    return np.sort(g.choice(n_tables, min(k, n_tables), replace=False))


class Kept:
    """The kept part of one answer."""

    def __init__(self, state, tables, hand_row: int, overflow_row: int,
                 reported):
        nb, F = state.shape[:2]
        flat = state.reshape(nb, F, PER_BLOCK)
        idx = torch.as_tensor(tables, device=state.device)
        self.rows = flat[idx // PER_BLOCK, :, idx % PER_BLOCK].T.clone()
        self.sums = torch.stack([flat[:, hand_row].sum(dtype=torch.int64),
                                 flat[:, overflow_row].sum(
                                     dtype=torch.int64)])
        self.reported = reported

    def host(self):
        """(rows int64 numpy [F, k], [hands, overflowed] summed over every
        table of the answer, what the program reported of them)."""
        return (self.rows.cpu().numpy().astype(np.int64),
                self.sums.cpu().numpy(), self.reported)


def compare(kept: Kept, ref_rows) -> tuple:
    """(tables whose rows differ from the reference's, |reported -
    summed| of hands plus of overflowed tables)."""
    rows, sums, reported = kept.host()
    ref = ref_rows.cpu().numpy().astype(np.int64)
    off = int((rows != ref).any(axis=0).sum())
    total = sum(abs(int(r) - int(s)) for r, s in zip(reported, sums)
                if r is not None)
    return off, total


def checked_requests(seed: int, n_answered: int) -> list:
    """The requests a check replays: one drawn from the run's seed among
    the first eight (when it was answered) and the last answered."""
    if n_answered < 1:
        raise RuntimeError("no request answered")
    first = int(seeds.rng(seed, "check", "requests").integers(0, 8))
    return sorted({first, n_answered - 1} & set(range(n_answered)))


class Engine(base.Base):
    """An engine cell's driver. A subclass gives ``_run(key)`` -> (final
    state, hands, (reported hands, reported overflowed tables or None))
    and ``_policy(control)``, the reference's keyword arguments of
    ``mcref.table.launch`` for its tables' play.

    The check replays ``check_tables`` tables drawn from the seed of the
    requests of ``checked_requests`` with the reference from their own
    first deal: ``tables_off_pct`` is the share whose state differs in any
    row, ``total_off`` the gap between what the program reported and the
    sums of its own rows over all its tables."""

    def __init__(self, config, traffic, device, seed):
        from montecarlo_tpu_torch.ops import cuda_engine
        super().__init__(device, seed)
        self.config, self.traffic = config, traffic
        self.cfg = table_config(config)
        self.T = int(traffic["tables"])
        self.slots = int(traffic["slots"])
        self.per_launch = int(traffic["slots_per_launch"])
        self.sample = sample_tables(seed, self.T, traffic["check_tables"])
        lay, _ = cuda_engine._field_layout(self.cfg.num_seats,
                                           self.cfg.rules)
        self.rows = (lay["hand_ct"][0], lay["overflow"][0])
        self.first = checked_requests(seed, 9)[0]
        self.kept = {}
        self.decisions_per_hand = None

    def warmup(self):
        """A request of the window's shapes, its answer kept as a window's
        is, so that every kernel the window runs is loaded before it."""
        state = self._run("warmup")[0]
        Kept(state, self.sample, *self.rows, (0, 0)).host()

    def request(self, i):
        state, hands, reported = self._run(i)
        kept = Kept(state, self.sample, *self.rows, reported)
        self.kept = {k: v for k, v in self.kept.items() if k == self.first}
        self.kept[i] = kept
        self.n_answered += 1
        return {"hands": hands, "table_slots": self.T * self.slots,
                "tables": self.T}

    def reference(self, i, control=False, decisions=None):
        """The reference's rows [F, k] of the sampled tables of request
        ``i``, and their hands."""
        from mcref import table
        c = self.config
        s = seeds.kernel_seed(self.seed, "request", i)
        idx = torch.as_tensor(self.sample, device=self.device)
        lay, _ = table.layout(c["seats"], c["rules"])
        st = table.unpack(table.first_state(
            s, idx, c["seats"], c["rules"], c["small_blind"],
            c["big_blind"], c["starting_stack"]), lay)
        for ls, n in table.launch_seeds(s, self.slots, self.per_launch):
            st = table.launch(st, ls, idx, c["seats"], n, c["rules"],
                              c["small_blind"], c["big_blind"],
                              c["starting_stack"], decisions=decisions,
                              **self._policy(control))
        return table.pack(st, lay), int(st["hand_ct"].sum())

    def check(self, control=False):
        off = total = n = hands = 0
        decisions = []
        for i in checked_requests(self.seed, self.n_answered):
            ref, h = self.reference(i, decisions=decisions)
            hands += h
            if control:
                got, _ = self.reference(i, control=True)
                off += int((got != ref).any(dim=0).sum())
            else:
                o, t = compare(self.kept[i], ref)
                off, total = off + o, total + t
            n += ref.shape[1]
        self.decisions_per_hand = sum(decisions) / max(hands, 1)
        lim = self.traffic["limits"]
        return [("tables_off_pct", 100.0 * off / n, lim["tables_off_pct"]),
                ("total_off", float(total), lim["total_off"])]
