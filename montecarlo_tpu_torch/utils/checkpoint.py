"""Table-state snapshots (checkpoint / resume): the port of
``montecarlo_tpu/utils/checkpoint.py``, in its file layout.

The reference loses everything on restart (all state lives in in-memory STM
refs, ``database.clj:5-6``). A batch of tables is a ``TableState`` of
tensors, so a snapshot is one ``.npz``: ``bets_impl`` and ``leaf_NNNN``,
the fields in ``TableState`` order with the street and the pot layers
nested, as JAX flattens its state. Every field round-trips losslessly,
and a resumed batch continues bit-identically: decks are functions of
(key, hand_idx). The port's key, int64 (seed mod 2^32, table) pairs, is
stored as uint32 [T, 2], the dtype of JAX's key data, and ``key_form``
"philox" marks it as the port's; a file of the older form stores it as
int64 and has no marker.

``bets_impl`` names the street's form, "layers" (a ``Layers``, one leaf
more) or "levels" (a ``Street``), by its type, as the JAX package writes
it; a file without it is "layers". ``load_states`` also reads a file that
the JAX package wrote for a batched state in either form: every field but
the key carries across, and the key, a threefry key the port cannot use,
becomes ``table_keys(seed)`` (as ``engine/state.state_from_numpy``). A JAX
file of the older form without ``street_raises``/``last_raiser`` loads
with their defaults. The JAX package loads the port's files of either
form: it reads the port's key words as threefry key data, so every field
but the decks of later hands carries across.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from montecarlo_tpu_torch.device import resolve
from montecarlo_tpu_torch.engine.bets import Layers
from montecarlo_tpu_torch.engine.state import TableState, table_keys
from montecarlo_tpu_torch.engine.street import Street

_FORMS = {"layers": Layers, "levels": Street}


def _leaves(states: TableState) -> List[np.ndarray]:
    out = []
    for name, x in zip(TableState._fields, states):
        parts = x if name in ("bets", "pots") else (x,)
        out += [p.detach().cpu().numpy() for p in parts]
    return out


def save_states(path: str, states: TableState) -> None:
    impl = "levels" if isinstance(states.bets, Street) else "layers"
    leaves = _leaves(states)
    leaves[0] = leaves[0].astype(np.uint32)  # (seed mod 2^32, table)
    np.savez_compressed(
        path, bets_impl=np.asarray(impl), key_form=np.asarray("philox"),
        **{f"leaf_{i:04d}": x for i, x in enumerate(leaves)})


def load_states(path: str, device=None, seed: int = 0) -> TableState:
    """The batch saved at ``path`` on ``device`` (the card when None).
    ``seed`` keys the tables of a JAX-written file (``table_keys``)."""
    dev = resolve(device)
    with np.load(path) as data:
        impl = str(data["bets_impl"]) if "bets_impl" in data.files \
            else "layers"
        ours = "key_form" in data.files and str(data["key_form"]) == "philox"
        flat = [data[k] for k in sorted(data.files) if k.startswith("leaf_")]
    if impl not in _FORMS:
        raise ValueError(f"{path}: bets_impl={impl!r}, expected one of "
                         f"{sorted(_FORMS)}")
    nested = {"bets": _FORMS[impl], "pots": Layers}
    n_leaves = len(TableState._fields) - 2 + sum(
        len(kind._fields) for kind in nested.values())
    if len(flat) == n_leaves - 2:
        # Snapshot predates the street_raises/last_raiser fields (appended
        # at the end of TableState, so the old leaf prefix is unchanged).
        # Defaults: no raise this street, P (= "none") for last_raiser.
        batch = flat[0].shape[:-1]  # key leaf is [..., 2]
        P = flat[3].shape[-2]       # hole leaf is [..., P, 2]
        flat = flat + [np.zeros(batch, np.int32), np.full(batch, P, np.int32)]
    if len(flat) != n_leaves:
        raise ValueError(f"{path}: {len(flat)} leaves, expected {n_leaves}")

    def tensor(a):
        return torch.tensor(a if a.dtype == np.bool_ else a.astype(np.int32),
                            device=dev)

    it = iter(flat)
    fields = {}
    for name in TableState._fields:
        if name in nested:
            kind = nested[name]
            fields[name] = kind(*(tensor(next(it)) for _ in kind._fields))
        else:
            fields[name] = next(it)
    key = fields["key"]
    if ours or key.dtype == np.int64:  # the port's own (seed, table) keys
        fields["key"] = torch.tensor(key.astype(np.int64), device=dev)
    else:
        fields["key"] = table_keys(seed, key.shape[0], dev)
    for name in TableState._fields:
        if name not in nested and name != "key":
            fields[name] = tensor(fields[name])
    return TableState(**fields)
