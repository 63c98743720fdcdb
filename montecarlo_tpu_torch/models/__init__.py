"""Policy models: the decision features, the policy MLP, rule bots,
evolution-strategies and REINFORCE training, CMA-ES, the fold leash, the
push/fold solver, the exact river and turn+river CFR+ solvers and the
distillation of their strategies.

The net on the table engine: ``state_features`` (the features of a
``TableState``), ``action_from_index`` and ``net_policy`` (a
``rollout/policy`` policy), ``save_params`` / ``load_params``;
``train_policy`` (REINFORCE, ``models/train.py``), ``CMAES``
(``models/cma.py``) and the leash's ``anchor_log_pfold`` /
``make_anchor_score`` (``models/leash.py``). The solvers
(``models/river_solver.py``, ``models/turn_solver.py``) and
``models/distill.py`` keep their JAX names; the names below are those the
scripts call (``models.distill`` stays the module: its ``distill``
function is not re-exported over it).
"""

from montecarlo_tpu_torch.models.cma import CMAES  # noqa: F401
from montecarlo_tpu_torch.models.features import (  # noqa: F401
    NUM_FEATURES,
    state_features,
)
from montecarlo_tpu_torch.models.policy_net import (  # noqa: F401
    NUM_ACTIONS,
    MLPParams,
    action_from_index,
    init_params,
    load_params,
    net_policy,
    policy_logits,
    save_params,
)
from montecarlo_tpu_torch.models.leash import (  # noqa: F401
    anchor_log_pfold,
    make_anchor_score,
)
from montecarlo_tpu_torch.models.train import train_policy  # noqa: F401
from montecarlo_tpu_torch.models.distill import (  # noqa: F401
    ExampleSet,
    prelude_examples,
    stack_examples,
    turn_river_examples,
)
from montecarlo_tpu_torch.models.river_solver import (  # noqa: F401
    RiverGame,
    RiverStrategy,
    make_river_game,
    net_river_strategy,
    river_node_states,
    solve_cfr_plus,
)
from montecarlo_tpu_torch.models.turn_solver import (  # noqa: F401
    TurnRiverGame,
    TurnRiverStrategy,
    best_response_strategy,
    make_turn_river_game,
    mix_strategies,
    net_turn_river_strategy,
    solve_turn_river,
    turn_river_node_states,
)
