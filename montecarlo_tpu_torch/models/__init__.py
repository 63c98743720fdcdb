"""Policy models: the decision features, the policy MLP, rule bots,
evolution-strategies and REINFORCE training, CMA-ES, the fold leash and
the push/fold solver.

The net on the table engine: ``state_features`` (the features of a
``TableState``), ``action_from_index`` and ``net_policy`` (a
``rollout/policy`` policy), ``save_params`` / ``load_params``;
``train_policy`` (REINFORCE, ``models/train.py``), ``CMAES``
(``models/cma.py``) and the leash's ``anchor_log_pfold`` /
``make_anchor_score`` (``models/leash.py``).
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
