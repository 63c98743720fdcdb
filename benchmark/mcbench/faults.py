"""Faults planted under a cell's timed path, to show that its check fails.

``plant(cell_driver, fault)`` returns [(module, attribute, replacement)]
for the program's function that the fault breaks; the caller swaps them
in (the tests with ``monkeypatch``, ``tools/readings.py`` for the run).
The faults a cell can have:

- ``unchanged``: the launch returns its state (or counts) unchanged;
- ``half``: half of the batch left out and the rest counted twice (the
  first half of the blocks, or half the rollouts);
- ``altered``: every answer altered where it is produced (every table's
  first stack plus one, every count plus one);
- ``reported``: the hands a request reports plus one (engine cells).
"""

from __future__ import annotations

import torch

FAULTS = ("unchanged", "half", "altered", "reported")
STACK_ROW = 12      # the packed state's first stack row


def _engine(module, name, fault):
    orig = getattr(module, name)

    def unchanged(seed, state, *a, **k):
        return state.clone()

    def half(seed, state, *a, **k):
        out = orig(seed, state[:state.shape[0] // 2].contiguous(), *a, **k)
        return torch.cat([out, out])

    def altered(seed, state, *a, **k):
        out = orig(seed, state, *a, **k)
        out[:, STACK_ROW] += 1
        return out

    return {"unchanged": unchanged, "half": half, "altered": altered}[fault]


def _counts(module, name, fault):
    orig = getattr(module, name)
    n_arg = 4 if name == "equity_counts" else 3

    def unchanged(*a, **k):
        return torch.zeros_like(orig(*a, **k))

    def half(*a, **k):
        a = list(a)
        a[n_arg] = a[n_arg] // 2
        return 2 * orig(*a, **k)

    def altered(*a, **k):
        return orig(*a, **k) + 1

    return {"unchanged": unchanged, "half": half, "altered": altered}[fault]


def plant(driver: str, fault: str) -> list:
    """The replacements that plant ``fault`` under the cells of driver
    ``driver`` (a traffic's ``driver``)."""
    from montecarlo_tpu_torch.ops import cuda_engine, cuda_equity, cuda_net
    if fault not in FAULTS:
        raise ValueError(f"fault {fault!r}: expected one of {FAULTS}")
    if fault == "reported":
        if driver == "selfplay":
            orig = cuda_engine.selfplay_perpetual_kernel

            def sp(*a, **k):
                state, hands, ovf = orig(*a, **k)
                return state, hands + 1, ovf
            return [(cuda_engine, "selfplay_perpetual_kernel", sp)]
        if driver == "league":
            orig_m = cuda_net.seat_meters

            def meters(*a, **k):
                m, e, hands = orig_m(*a, **k)
                return m, e, hands + 1
            return [(cuda_net, "seat_meters", meters)]
        raise ValueError(f"{driver} reports no hands")
    target = {"selfplay": (cuda_engine, "run_perpetual_prng"),
              "league": (cuda_net, "run_net_league"),
              "equity_queries": (cuda_equity, "equity_counts"),
              "sweep": (cuda_equity, "sweep_counts")}[driver]
    make = _engine if driver in ("selfplay", "league") else _counts
    return [(*target, make(*target, fault))]
