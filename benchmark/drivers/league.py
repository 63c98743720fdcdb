"""Head-to-head net evaluation on B7 (``ops/cuda_net``).

A request is one evaluation as ``cuda_net.selfplay_net_league`` runs it,
call for call: a new first state (``initial_packed_state``), the banks'
weights uploaded (``bank_weights``), ``slots`` betting slots in launches
of ``slots_per_launch`` (``run_net_league``, launch seeds (s + done *
7919) & 0x7FFFFFFF), every hand from full stacks, and the per-seat meters
read back (``seat_meters``). The entry's calls are made here, not through
the entry, so that the check has the final state; the Philox seed s is
drawn from the run's seed and the request's index. Seat k plays bank
``seat_to_bank[k]`` of ``banks`` (nets of the configuration) when it is
in ``net_seats`` (-1: every seat), the random policy otherwise.

The check is ``mcbench.tables.Engine``'s, the reference playing the same
nets; ``check(control=True)`` puts the reference with its MLP on
bfloat16 inputs in the program's place. Work: hands, table slots, and
net decisions, which no answer reports: the reference's decisions a hand
over the tables it replays, times the hands of the window.
"""

from __future__ import annotations

import torch

from mcbench import seeds, tables

MAIN_KERNEL = "mc_net_eval_kernel"


class Driver(tables.Engine):
    def __init__(self, config, traffic, device, seed):
        from montecarlo_tpu_torch.models.policy_net import MLPParams
        super().__init__(config, traffic, device, seed)
        P = self.cfg.num_seats
        self.stb = tuple(traffic["seat_to_bank"])
        ns = int(traffic["net_seats"])
        self.net_seats = (1 << P) - 1 if ns == -1 else ns
        self.nets = [tables.load_net(config, b) for b in traffic["banks"]]
        self.banks = [MLPParams(*(torch.tensor(x) for x in net))
                      for net in self.nets]

    def _run(self, key):
        from montecarlo_tpu_torch.ops import cuda_net as cn
        cfg = self.cfg
        s = seeds.kernel_seed(self.seed, "request", key)
        with self.span("req.first_state"):
            state = cn.initial_packed_state(s, cfg, self.T, self.device)
        with self.span("req.weights"):
            weights = cn.bank_weights(self.banks, state.device)
        done = 0
        while done < self.slots:
            n = min(self.per_launch, self.slots - done)
            with self.span("req.launch"):
                state = cn.run_net_league(
                    (s + done * 7919) & 0x7FFFFFFF, state, weights,
                    cfg.num_seats, n, cfg.small_blind, cfg.big_blind,
                    cfg.starting_stack, cfg.rules, self.net_seats, self.stb)
            done += n
        with self.span("req.meters"):
            _, _, hands = cn.seat_meters(state, cfg)
        return state, hands, (hands, None)

    def _policy(self, control):
        return {"nets": [[torch.as_tensor(x, device=self.device)
                          for x in net] for net in self.nets],
                "seat_to_bank": self.stb, "net_seats": self.net_seats,
                "reset_stacks": True, "mlp": "bf16" if control else "f32"}

    def extra_work(self):
        """The window's net decisions, estimated from the reference's
        replay (after ``check``), as a rate a hand."""
        if self.decisions_per_hand is None:
            return {}
        return {"decisions_per_hand": self.decisions_per_hand}
