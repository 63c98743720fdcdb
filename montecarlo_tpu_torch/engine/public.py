"""Host-side public projection of a table: ``montecarlo_tpu/engine/public.py``
for one table of a batched state.

Mirrors ``read-board`` (``helpers.clj:33-43``) and the card/hand JSON shapes
the reference server emits (``README.md:52-57``): community cards, bet and
pot layers, remaining players, the visible play-order window, the logical
clock and per-player public stacks. Hole cards stay private (served per
player by the ``hand`` query, newest card first).

State is indexed by hand-order *position*; ``ids`` by stable *seat*;
``seat = (button + position) % P`` bridges the two here. Every function
takes the table's index in the batch (``table``, default 0). Host code:
never on the device hot path.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from montecarlo_tpu_torch.cards import SUIT_NAMES, card_rank, card_suit
from montecarlo_tpu_torch.engine.state import TableState, _tree_map
from montecarlo_tpu_torch.engine.street import bets_as_layers


def card_json(card: int) -> Dict:
    return {"suit": SUIT_NAMES[int(card_suit(int(card)))],
            "rank": int(card_rank(int(card)))}


def _one(state: TableState, table: int) -> TableState:
    """Table ``table`` of the batch as numpy, its street as layers."""
    st = _tree_map(lambda x: x[table:table + 1], state)
    st = st._replace(bets=bets_as_layers(st.bets, st.folded))
    return _tree_map(lambda x: x[0].cpu().numpy(), st)


def ids_by_position(state: TableState, ids: Sequence[str],
                    table: int = 0) -> List[str]:
    """Player ids in hand-order (position) order."""
    P = state.num_seats
    button = int(state.button[table])
    return [ids[(button + j) % P] for j in range(P)]


def _pos_ids(mask, ids_pos: Sequence[str]) -> List[str]:
    return [ids_pos[j] for j in range(len(ids_pos)) if mask[j]]


def _bitmask_ids(mask: int, ids_pos: Sequence[str]) -> List[str]:
    return [ids_pos[j] for j in range(len(ids_pos)) if (int(mask) >> j) & 1]


def _layers_json(layers, ids_pos: Sequence[str]) -> List[Dict]:
    return [{"bet": int(layers.amt[i]),
             "players": _bitmask_ids(layers.mem[i], ids_pos),
             "original-players": _bitmask_ids(layers.orig[i], ids_pos),
             "n": int(layers.n[i])}
            for i in range(int(layers.count))]


def public_board(state: TableState, ids: Sequence[str],
                 table: int = 0) -> Dict:
    """The client-visible board map of one table (``helpers.clj:33-43``).

    ``ids[seat]`` names each stable seat. Player sets are emitted in hand
    order (the reference serializes Clojure sets, whose order is
    unspecified)."""
    ids_pos = ids_by_position(state, ids, table)
    st = _one(state, table)
    P = len(st.stacks)
    n_players = int(st.in_hand.sum())

    # play-order: the first |players| elements of the filtered cycle from
    # the cursor (helpers.clj:37-39).
    play_order: List[str] = []
    j = int(st.cursor)
    while len(play_order) < n_players:
        if st.order_mask[j % P]:
            play_order.append(ids_pos[j % P])
        j += 1
        if j > int(st.cursor) + 2 * P:  # order_mask covers in_hand
            break

    return {
        "community-cards": [card_json(c) for c in
                            st.community[: int(st.n_community)]],
        "bets": _layers_json(st.bets, ids_pos),
        "pots": _layers_json(st.pots, ids_pos),
        "remaining-players": _pos_ids(st.to_act, ids_pos),
        "play-order": play_order,
        "time": int(st.time),
        "players": [{"id": ids_pos[j], "stack": int(st.stacks[j])}
                    for j in range(P) if st.in_hand[j]],
    }


def player_hand_json(state: TableState, seat: int,
                     table: int = 0) -> List[Dict]:
    """The ``hand`` query payload for a stable seat of one table: hole
    cards, newest first (``server.clj:92-101``)."""
    P = state.num_seats
    pos = (seat - int(state.button[table])) % P
    hole = state.hole[table, pos].tolist()
    return [card_json(hole[1]), card_json(hole[0])]
