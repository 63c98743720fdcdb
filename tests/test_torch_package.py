"""Package-level properties of the port: no JAX at runtime, the shared
encodings, and no silent CPU fallback where a card was asked for."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from montecarlo_tpu import cards, handval
from montecarlo_tpu.engine.state import TableConfig as JaxTableConfig
from montecarlo_tpu_torch.engine.state import TableConfig
from montecarlo_tpu_torch.ops import cuda_engine as ce
from montecarlo_tpu_torch.ops import cuda_equity as cq
from montecarlo_tpu_torch.ops import evaluator as tev
from montecarlo_tpu_torch.ops import philox
from montecarlo_tpu_torch.rollout import equity as teq

ROOT = Path(__file__).resolve().parent.parent
MODULES = [
    "montecarlo_tpu_torch",
    "montecarlo_tpu_torch.device",
    "montecarlo_tpu_torch.engine.state",
    "montecarlo_tpu_torch.ops._build",
    "montecarlo_tpu_torch.ops.evaluator",
    "montecarlo_tpu_torch.ops.philox",
    "montecarlo_tpu_torch.ops.cuda_equity",
    "montecarlo_tpu_torch.ops.cuda_engine",
    "montecarlo_tpu_torch.rollout.equity",
]


def _clean_env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    code = ("import importlib, json, sys\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted(k for k in sys.modules if k == 'jax' "
            "or k.startswith(('jax.', 'montecarlo_tpu.')) "
            "or k == 'montecarlo_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=120, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_shared_encodings_and_table_config_match_jax():
    import montecarlo_tpu_torch

    assert montecarlo_tpu_torch.cards is cards
    assert montecarlo_tpu_torch.handval is handval
    assert tev.NUM_RANKS == cards.NUM_RANKS
    assert teq.NUM_CARDS == cards.NUM_CARDS
    assert tev.CAT_SHIFT == handval.CAT_SHIFT
    for name in ("CAT_HIGH", "CAT_PAIR", "CAT_TWO_PAIR", "CAT_TRIPS",
                 "CAT_STRAIGHT", "CAT_FLUSH", "CAT_FULL_HOUSE", "CAT_QUADS",
                 "CAT_STRAIGHT_FLUSH"):
        assert getattr(tev, name) == getattr(handval, name), name
    assert all(teq.make_card(s, r) == cards.make_card(s, r)
               for s in range(4) for r in range(2, 15))
    ours = [(f.name, f.default) for f in dataclasses.fields(TableConfig)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(JaxTableConfig)]
    assert ours == theirs


def test_cuda_requests_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the wrappers launch kernels here")
    from montecarlo_tpu_torch.device import cuda_device

    with pytest.raises(RuntimeError):
        cuda_device()
    with pytest.raises((RuntimeError, AssertionError)):
        teq.equity_vs_hand(0, [0, 1], [2, 3], 1024, device="cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        cq.equity_sweep_kernel(0, [[0, 1]], 1024, device="cuda")
    cfg = TableConfig(num_seats=6)
    with pytest.raises((RuntimeError, AssertionError)):
        ce.selfplay_perpetual_kernel(0, cfg, 1024, 16, device="cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        philox.philox_blocks(torch.zeros((1, 6), dtype=torch.int64,
                                         device="cuda"))
    assert all(v == 0 for v in {**cq.LAUNCHES, **ce.LAUNCHES,
                                **philox.LAUNCHES}.values())


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = _clean_env()
    here = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert here.returncode != 0 and '"ok": true' not in here.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env.pop("PYTHONPATH")
    alone = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                           env=env, capture_output=True, text=True,
                           timeout=120)
    assert alone.returncode != 0 and '"ok": true' not in alone.stdout
