"""Ports of the reference's scripts, each run as ``python -m
montecarlo_tpu_torch.scripts.<name>`` from the repository root, on the card
unless a function is given ``device="cpu"``:

- measurement scripts that build kernels of their own
  (``exp_carry_model``, ``debug_kernel_compile``), the push/fold
  artifacts' build (``build_pushfold_cr``), the A/B of this tree's
  kernels against another tree's (``ab_engine``), the operation and byte
  count of a table-engine step (``count_engine_ops``), its time
  (``time_step_table``) and the A/B of its two street forms
  (``exp_levels_ab``);
- the league and exploitability scripts: ``league_eval`` (B7 head to
  head), ``exploit_probe`` (the rule-bot panel), ``opt_bot`` (CMA-ES
  attackers), ``eval_attacker`` (a net attacker);
- training: ``train_es_kernel`` (ES on the net kernels, with the fold
  leash), ``train_policy``, ``train_br`` and ``train_mix`` (REINFORCE on
  the plain table engine);
- the decision-point analysis: ``exp_leak_anatomy``, ``fold_gate_check``,
  ``policy_diff`` and ``make_fold_anchor``;
- the solver scripts: ``river_gap`` and ``turn_gap`` (the Nash-gap meters
  of the exact river and turn+river subgames) and ``distill_nash`` (Nash
  and solver-BR distillation);
- the server's load test: ``bench_server`` (N rooms x M actions over TCP
  against an in-process server, native or torch rooms);
- the five BASELINE configs: ``run_configs`` (config 5 on the sweep
  kernel, or the sharded plain sweep on the CPU).

Every script that writes an artifact takes its path as a required
``--save``: ``data/``'s artifacts are the reference.
"""
