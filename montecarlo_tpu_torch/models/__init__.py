"""Policy models: the decision features, the policy MLP, rule bots,
evolution-strategies training and the push/fold solver.

The net on the table engine: ``state_features`` (the features of a
``TableState``), ``action_from_index`` and ``net_policy`` (a
``rollout/policy`` policy), ``save_params`` / ``load_params``.
"""

from montecarlo_tpu_torch.models.features import (  # noqa: F401
    NUM_FEATURES,
    state_features,
)
from montecarlo_tpu_torch.models.policy_net import (  # noqa: F401
    MLPParams,
    action_from_index,
    load_params,
    net_policy,
    policy_logits,
    save_params,
)
