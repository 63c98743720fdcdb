"""Action encoding (``action.clj``): a copy of ``montecarlo_tpu/actions.py``.

Actions are single integers: negative = fold, 0 = call (a check when
nothing is owed), positive = raise **by** that amount on top of the
standing total (``action.clj:12-29``). Works on Python ints and tensors.
"""

FOLD = -1  # action.clj:12
CALL = 0   # action.clj:13


def is_fold(action):
    return action < 0


def is_call(action):
    return action == 0


def is_raise(action):
    return action > 0


def raise_by(amount: int) -> int:
    """The raise action for raising by ``amount`` (``action->raise`` is the
    identity, ``action.clj:27-29``)."""
    assert amount > 0
    return amount
