"""The table engine: ``montecarlo_tpu/engine`` in plain PyTorch, tables on
a leading axis.

- ``bets.py``    the layer algebra of ``bet.clj`` (``Layers``, seat
                 bitmasks): the "layers" street form and the pot record;
- ``street.py``  the "levels" street form, its layer view, and the
                 dispatch between the two forms;
- ``state.py``   ``TableConfig``, ``TableState``, the Philox deck and hand
                 setup (``init_state``, ``begin_hand``, ``redeal``,
                 ``next_hand``), and the numpy carry to and from a JAX state;
- ``step.py``    actions, street transitions, showdown, ``step_action`` and
                 ``step_table``;
- ``public.py``  the host JSON view of one table;
- ``replay.py``  the engine on K3's injected stream, with K3's field view.
"""

from montecarlo_tpu_torch.engine.bets import (  # noqa: F401
    Layers,
    empty_layers,
    merge_bets,
    needed_bet,
    remove_player,
    total_bet,
    update_bets,
)
from montecarlo_tpu_torch.engine.street import (  # noqa: F401
    Street,
    bets_as_layers,
    bets_needed,
    bets_total,
    empty_street,
)
from montecarlo_tpu_torch.engine.state import (  # noqa: F401
    TableConfig,
    TableState,
    begin_hand,
    init_state,
    next_hand,
    redeal,
)
from montecarlo_tpu_torch.engine.step import (  # noqa: F401
    apply_action,
    clamp_action,
    game_end,
    head_info,
    settle_showdown,
    stage_end,
    stage_transition,
    step_action,
    step_table,
)
from montecarlo_tpu_torch.engine.public import (  # noqa: F401
    player_hand_json,
    public_board,
)
