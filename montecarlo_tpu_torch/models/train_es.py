"""Evolution-strategies training on the net kernels.

The counterpart of ``montecarlo_tpu/models/train_es.py``. The kernels meter
per-seat settled deltas on the card at millions of hands a second but are
not differentiable, so the trainer is evolution strategies (Salimans et al.
2017, "Evolution Strategies as a Scalable Alternative to RL"): sample
antithetic Gaussian perturbations of the policy weights, measure each
candidate's bb/hand at its pinned seat with the kernels' meters, and
ascend the fitness-weighted perturbation mean

    g = (1 / pop) * sum_i f_std(theta + sigma*eps_i) * eps_i.

Variance control: antithetic pairs (+eps, -eps) and common random numbers
— every candidate of a generation is evaluated on the same seed (the same
deals), so pair differences cancel card luck. Fitnesses are standardized
per generation.

``train_es`` is host code: the center, the perturbations and the update
are float32 CPU tensors, and the evaluators take the candidates to the
card. The perturbations come from a ``torch.Generator`` seeded by
``seed``, so they differ from the JAX package's threefry draws; the
arithmetic around them is the JAX package's.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from montecarlo_tpu_torch.models.policy_net import MLPParams
from montecarlo_tpu_torch.ops import cuda_net as cn

F32 = torch.float32


def _flatten(params: MLPParams):
    """(flat float32 vector, spec) of an ``MLPParams``."""
    shapes = [tuple(leaf.shape) for leaf in params]
    sizes = [int(np.prod(s)) for s in shapes]
    vec = torch.cat([torch.as_tensor(leaf, dtype=F32).reshape(-1)
                     for leaf in params])
    return vec, (type(params), shapes, sizes)


def _unflatten(vec, spec) -> MLPParams:
    kind, shapes, sizes = spec
    leaves, off = [], 0
    for shape, size in zip(shapes, sizes):
        leaves.append(vec[off:off + size].reshape(shape))
        off += size
    return kind(*leaves)


def _perturbations(generator: torch.Generator, pop: int, dim: int):
    """A generation's perturbations: standard normal float32 [pop, dim]."""
    return torch.randn((pop, dim), generator=generator, dtype=F32)


class ESResult(NamedTuple):
    params: MLPParams             # center at the best-mean generation
    fitness_history: np.ndarray   # [generations] mean fitness
    best_fitness: float
    hands_total: int
    final_params: Optional[MLPParams] = None  # last-generation center


def train_es(
    seed: int,
    params0: MLPParams,
    eval_fn: Optional[Callable] = None,  # (params, seed) -> (fitness, hands)
    generations: int = 40,
    pop: int = 8,                 # antithetic pairs per generation
    sigma: float = 0.05,
    lr: float = 0.03,
    momentum: float = 0.9,
    mask: Optional[torch.Tensor] = None,  # 0/1 over the flat vector
    progress: Optional[Callable] = None,
    eval_pop_fn: Optional[Callable] = None,  # ([params], seed) ->
                                             # (fits[2*pop], hands[2*pop])
    noise_floor: float = 0.0,
    center_eval_fn: Optional[Callable] = None,  # (params) -> fitness
    center_eval_every: int = 10,
    checkpoint_fn: Optional[Callable] = None,  # (g, center, best,
                                               #  best_quality) -> None
    adapt_fn: Optional[Callable] = None,  # (g, center) -> None
    adapt_every: int = 0,
) -> ESResult:
    """Antithetic ES ascent on ``eval_fn``'s fitness.

    ``pop`` counts pairs: each generation evaluates ``2*pop`` candidates
    and never the center (the standardized pair differences carry the
    signal). All candidates of a generation share one eval seed (common
    random numbers). ``eval_pop_fn`` receives the whole generation at
    once, ordered ``[+eps_0, -eps_0, +eps_1, ...]`` — the population
    kernel's path, one launch per generation instead of ``2*pop``.

    ``noise_floor`` (fitness units) guards against spread collapse:
    fitness is standardized by ``max(std(diff), noise_floor)``, so when
    perturbations stop flipping any action the update damps toward zero
    instead of amplifying noise into a full lr-sized step. The returned
    ``params`` is the center at its best measured quality, not the final
    center. Quality is ``center_eval_fn`` (every ``center_eval_every``
    generations, plus the last) when given — use a fixed holdout seed in
    it, so the snapshots share common random numbers; else the best
    per-generation mean. ``checkpoint_fn`` runs after each center
    evaluation; ``adapt_fn`` runs every ``adapt_every`` generations
    (from generation 0) on the current center, before that generation's
    evaluation, so an evaluator that re-reads a mutable opponent pool sees
    a refreshed opponent at once.
    """
    if (eval_fn is None) == (eval_pop_fn is None):
        raise ValueError("exactly one of eval_fn / eval_pop_fn")
    vec, spec = _flatten(params0)
    vel = torch.zeros_like(vec)
    gen = torch.Generator().manual_seed(seed)
    hist, hands_total, best = [], 0, -np.inf
    best_mean, best_vec = -np.inf, vec

    for g in range(generations):
        if adapt_fn is not None and adapt_every > 0 \
                and g % adapt_every == 0:
            adapt_fn(g, _unflatten(vec, spec))
        eps = _perturbations(gen, pop, vec.shape[0])
        if mask is not None:
            # restrict the search to a parameter subspace (ES progress per
            # generation scales like pop/dim)
            eps = eps * mask[None]
        eval_seed = seed * 1_000_003 + g
        fits = np.zeros((pop, 2))
        if eval_pop_fn is not None:
            cands = [_unflatten(vec + sgn * sigma * eps[i], spec)
                     for i in range(pop) for sgn in (1.0, -1.0)]
            fs, hs = eval_pop_fn(cands, eval_seed)
            fits[:] = np.asarray(fs).reshape(pop, 2)
            hands_total += int(np.sum(hs))
        else:
            for i in range(pop):
                for j, sgn in enumerate((1.0, -1.0)):
                    cand = _unflatten(vec + sgn * sigma * eps[i], spec)
                    f, h = eval_fn(cand, eval_seed)
                    fits[i, j] = f
                    hands_total += h
        mean_fit = float(fits.mean())
        hist.append(mean_fit)
        best = max(best, float(fits.max()))
        if center_eval_fn is not None:
            if g % center_eval_every == 0 or g == generations - 1:
                cf = float(center_eval_fn(_unflatten(vec, spec)))
                if cf > best_mean:
                    best_mean, best_vec = cf, vec
                if checkpoint_fn is not None:
                    checkpoint_fn(g, _unflatten(vec, spec),
                                  _unflatten(best_vec, spec), best_mean)
        elif mean_fit > best_mean:
            # the generation's mean fitness estimates the center's
            # (antithetic pairs cancel the O(sigma) term): snapshot before
            # updating
            best_mean, best_vec = mean_fit, vec
        # standardized antithetic ascent direction; lr sets the step in
        # weight space directly (no 1/sigma factor)
        diff = (fits[:, 0] - fits[:, 1]) / 2.0       # [pop]
        std = max(float(diff.std()), noise_floor) + 1e-8
        w = torch.as_tensor(diff / std, dtype=vec.dtype)
        grad = (w[:, None] * eps).mean(dim=0)
        vel = momentum * vel + (1.0 - momentum) * grad
        vec = vec + lr * vel
        if progress is not None:
            progress(g, mean_fit, float(fits.max()),
                     float(fits.max() - fits.min()))

    return ESResult(_unflatten(best_vec, spec), np.asarray(hist), best,
                    hands_total, _unflatten(vec, spec))


def layer_mask(params: MLPParams, names) -> torch.Tensor:
    """0/1 flat-vector mask selecting the given MLPParams field names."""
    return torch.cat([torch.full((int(np.prod(leaf.shape)),),
                                 1.0 if field in names else 0.0, dtype=F32)
                      for field, leaf in zip(params._fields, params)])


def _state_cache(cfg, n_tables, device):
    """The first state of an eval seed, built once per seed: every
    candidate of a generation shares it (common random numbers)."""
    cache = {}

    def state0(eval_seed):
        if eval_seed not in cache:
            cache.clear()
            cache[eval_seed] = cn.initial_packed_state(eval_seed, cfg,
                                                       n_tables, device)
        return cache[eval_seed]
    return state0


def _lowest_seat(net_seats: int) -> int:
    return int(np.log2(net_seats & -net_seats))


def kernel_eval_fn(cfg, net_seats: int = 1, n_tables: int = 1 << 14,
                   n_steps: int = 256, device=None):
    """Fitness = mean bb/hand at the lowest pinned net seat, one K6
    evaluation per candidate on ``device`` (the card when None)."""
    seat = _lowest_seat(net_seats)
    state0 = _state_cache(cfg, n_tables, device)

    def eval_fn(params, eval_seed: int):
        means, _, hands = cn.selfplay_net_eval_kernel(
            eval_seed, cfg, params, net_seats=net_seats, n_tables=n_tables,
            n_steps=n_steps, state0=state0(eval_seed))
        return float(means[seat]), int(hands)

    return eval_fn


def kernel_eval_pop_fn(cfg, net_seats: int = 1, n_tables: int = 1 << 14,
                       n_steps: int = 256, device=None):
    """Population form of ``kernel_eval_fn``: the whole generation in one
    B8 launch per chunk, on common random numbers by construction (table t
    of every candidate reads the same Philox stream)."""
    seat = _lowest_seat(net_seats)
    state0 = _state_cache(cfg, n_tables, device)

    def eval_pop(params_list, eval_seed: int):
        means, _, hands = cn.selfplay_net_eval_pop(
            eval_seed, cfg, params_list, net_seats=net_seats,
            n_tables=n_tables, n_steps=n_steps, state0=state0(eval_seed))
        return means[:, seat], hands

    return eval_pop


def kernel_league_eval_pop_fn(cfg, opponent, n_tables: int = 1 << 14,
                              n_steps: int = 256, seat: int = 0,
                              device=None):
    """League fitness of a population: each candidate plays ``seat``
    against the fixed ``opponent`` net at every other seat (B8 with
    B = 2)."""
    state0 = _state_cache(cfg, n_tables, device)
    seat_to_bank = tuple(0 if k == seat else 1 for k in range(cfg.num_seats))

    def eval_pop(params_list, eval_seed: int):
        means, _, hands = cn.selfplay_net_league_pop(
            eval_seed, cfg, params_list, opponent, n_tables=n_tables,
            n_steps=n_steps, seat_to_bank=seat_to_bank,
            state0=state0(eval_seed))
        return means[:, seat], hands

    return eval_pop


def kernel_pool_eval_pop_fn(cfg, opponents, n_tables: int = 1 << 14,
                            n_steps: int = 256, seat: int = 0, device=None):
    """Opponent-pool fitness: the mean over pool members of the
    candidate's bb/hand. ``opponents`` entries are ``None`` (random
    opponents: the B8 launch with one bank), an ``MLPParams`` opponent (B8
    with the opponent as bank 1; the rule bots of ``models/bots.py`` are
    nets) or a ``(params_or_None, geometry)`` tuple, geometry

    - ``"five"`` (default): the candidate sits alone at ``seat`` against
      P-1 copies of the opponent; fitness = the candidate's seat bb/hand;
    - ``"lone"``: the opponent sits alone at ``seat`` against P-1 copies
      of the candidate; fitness = the sum over the candidate's seats
      (= minus the opponent's bb/hand under exact conservation).

    Every member plays from the same per-seed first state, so fitness
    differences across members carry opponent identity only.
    ``opponents`` is re-read on every call: a caller may replace entries
    in place between generations (``train_es``'s ``adapt_fn`` hook)."""
    if len(opponents) < 1:
        raise ValueError("an opponent pool needs at least one member")
    P = cfg.num_seats
    state0 = _state_cache(cfg, n_tables, device)

    def eval_pop(params_list, eval_seed: int):
        s0 = state0(eval_seed)
        tot, hands_sum = None, 0
        for entry in opponents:
            # MLPParams is a NamedTuple (a tuple subclass): only a plain
            # 2-tuple ending in a geometry string is (opp, geom)
            if (type(entry) is tuple and len(entry) == 2
                    and isinstance(entry[1], str)):
                opp, geom = entry
            else:
                opp, geom = entry, "five"
            cand_seats = ([seat] if geom == "five"
                          else [k for k in range(P) if k != seat])
            if opp is None:
                m, _, h = cn.selfplay_net_eval_pop(
                    eval_seed, cfg, params_list,
                    net_seats=sum(1 << k for k in cand_seats),
                    n_tables=n_tables, n_steps=n_steps, state0=s0)
            else:
                stb = tuple(0 if k in cand_seats else 1 for k in range(P))
                m, _, h = cn.selfplay_net_league_pop(
                    eval_seed, cfg, params_list, opp, n_tables=n_tables,
                    n_steps=n_steps, seat_to_bank=stb, state0=s0)
            vals = np.asarray(m)[:, cand_seats]
            # "lone": the sum over the candidate's seats is minus the
            # opponent's bb/hand, the scale of the "five" components
            f = vals.sum(axis=1) if geom == "lone" else vals.mean(axis=1)
            tot = f if tot is None else tot + f
            hands_sum += int(np.sum(h))
        return tot / len(opponents), hands_sum

    return eval_pop
