"""K1's variants (B-6): the plain versions against the JAX K1 body under
the script's patches, and the device code compiled for the CPU against the
plain versions.

``scripts/bench_kernel_variants.py`` swaps ``pallas_equity``'s
``_uniform_draws``, ``_masks_of`` and ``eval_masks_cmp_impl`` per variant.
The JAX kernel draws from the TPU's PRNG, which has no CPU lowering, so,
as in ``tests/test_torch_equity.py``'s B3 case, the JAX side here is
program 0 of ``_make_equity_kernel`` on one (128, 128) tile with the
script's patches applied by ``monkeypatch`` and ``pl`` / ``pltpu``
replaced by stubs that hand out injected words in the variant's draw
order (the script's samplers call their own module's ``pltpu``, which is
stubbed too). The port's plain variant on the same words must give equal
wins and ties, and every word must be consumed. The script is loaded
from its file (``importlib``).

The device code (``csrc/probe_k1.cuh``) is host C++ as well: a harness
built with the host compiler runs every variant's rollout, on injected
words and in Philox mode, against the plain version.
"""

import importlib.util
import os
import shutil
import subprocess
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.cards import make_card
from montecarlo_tpu.ops import pallas_equity as pe
from montecarlo_tpu_torch.ops import _build
from montecarlo_tpu_torch.ops import cuda_equity as cq
from montecarlo_tpu_torch.ops import cuda_k1_variants as kv
from montecarlo_tpu_torch.scripts import bench_kernel_variants as bkv

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
JAX_CACHE_KEYS = ("jax_compilation_cache_dir",
                  "jax_persistent_cache_min_compile_time_secs")
AKS = [make_card(0, 14), make_card(0, 13)]
QQ = [make_card(1, 12), make_card(2, 12)]
# a matchup with flush and straight chances on both sides
SUITED = [make_card(3, 9), make_card(3, 8)]
OFF = [make_card(1, 10), make_card(2, 7)]


def _load_script(name):
    """A JAX script from ``scripts/``; its import points JAX's compile cache
    at its TPU directory and makes that directory: both are undone."""
    saved = {k: getattr(jax.config, k) for k in JAX_CACHE_KEYS}
    makedirs = os.makedirs
    os.makedirs = lambda *a, **k: None
    try:
        spec = importlib.util.spec_from_file_location(
            f"reference_{name}", ROOT / "scripts" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        os.makedirs = makedirs
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


@pytest.fixture(scope="module")
def script():
    return _load_script("bench_kernel_variants")


def test_variants_and_sizes_are_the_scripts(script):
    assert tuple(script.VARIANTS) == kv.VARIANTS == _build.K1_VARIANTS
    assert set(kv.SPEC) == set(kv.VARIANTS)
    defaults = {a.dest: a.default for a in bkv.parser()._actions}
    assert defaults["n"] == 1 << 29
    assert defaults["variants"] == ",".join(script.VARIANTS)
    assert defaults["tile_variant"] == "current"


def _words(rng, variant, n):
    """Random words [n_words, n] with some at 2^32 - 1, in the top range
    of every bound, so that ``fallback_word`` takes its fallback."""
    w = rng.integers(0, 1 << 32, (kv.n_words(variant), n), dtype=np.int64)
    w[rng.random(w.shape) < 0.02] = (1 << 32) - 1
    return w


def _jax_counts(monkeypatch, script, variant, words, hero, villain):
    """Program 0 of ``_make_equity_kernel(4, 5)`` on one tile under the
    script's patches for ``variant``, fed ``words`` [K, TILE_N] in order:
    (wins, ties); asserts every word was consumed."""
    draws = iter([jnp.asarray(w.astype(np.uint32).reshape(pe.TILE))
                  for w in words])
    stub = types.SimpleNamespace(prng_seed=lambda seed: None,
                                 prng_random_bits=lambda shape: next(draws))
    monkeypatch.setattr(pe, "pl", types.SimpleNamespace(
        program_id=lambda axis: 0,
        when=lambda cond: (lambda body: body() if cond else None)))
    monkeypatch.setattr(pe, "pltpu", stub)
    monkeypatch.setattr(script, "pltpu", stub)
    spec = script.VARIANTS[variant]
    if "sampler" in spec:
        monkeypatch.setattr(pe, "_uniform_draws", spec["sampler"])
    if "masks" in spec:
        monkeypatch.setattr(pe, "_masks_of", spec["masks"])
    if "eval" in spec:
        monkeypatch.setattr(pe, "eval_masks_cmp_impl", spec["eval"])
    if "eval_factory" in spec:
        monkeypatch.setattr(pe, "eval_masks_cmp_impl",
                            spec["eval_factory"]())
    dead, hm, vm = cq._hand_masks(hero, villain, (), "cpu")
    wins = np.zeros((1, 1), np.int32)
    ties = np.zeros((1, 1), np.int32)
    pe._make_equity_kernel(4, 5)(np.zeros(1, np.int32), dead.numpy(),
                                 hm.numpy(), vm.numpy(), wins, ties)
    assert next(draws, None) is None  # every word consumed
    return int(wins[0, 0]), int(ties[0, 0])


@pytest.mark.parametrize("hands", ["aks_qq", "suited_off"])
@pytest.mark.parametrize("variant", kv.VARIANTS)
def test_plain_variant_equals_jax_body_under_patches(monkeypatch, script,
                                                     variant, hands):
    hero, villain = {"aks_qq": (AKS, QQ), "suited_off": (SUITED, OFF)}[hands]
    rng = np.random.default_rng(kv.VARIANTS.index(variant) + 17 * len(hands))
    words = _words(rng, variant, pe.TILE_N)
    want = _jax_counts(monkeypatch, script, variant, words, hero, villain)
    dead, hm, vm = cq._hand_masks(hero, villain, (), "cpu")
    got = kv.variant_counts(variant, 0, dead, hm, vm, pe.TILE_N,
                            words=torch.from_numpy(words))
    assert tuple(got.tolist()) == want
    assert sum(want) > 0


def test_ms16_is_the_high_word_of_the_product():
    """The script's 16-bit-halves form equals (x n) >> 32 (the card's
    __umulhi) on random and edge words for every n in 48..52."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(np.concatenate([
        rng.integers(0, 1 << 32, 1 << 16, dtype=np.int64),
        np.array([0, 1, 0xFFFF, 0x10000, 0x7FFFFFFF, 0x80000000,
                  0xFFFF0000, 0xFFFFFFFF], np.int64)]))
    for n in range(48, 53):
        assert torch.equal(kv.ms16(x, n), (x * n) >> 32)


def test_equal_classes_hold_on_philox_rollouts():
    """At 2^16 Philox rollouts the variants of a class count alike, and the
    wrapper's Philox words are the first words of K1's stream."""
    dead, hm, vm = cq._hand_masks(AKS, QQ, (), "cpu")
    n = 1 << 16
    counts = {v: kv.variant_counts(v, 29, dead, hm, vm, n).tolist()
              for v in kv.VARIANTS}
    for cls in kv.EQUAL_CLASSES:
        assert len({tuple(counts[v]) for v in cls}) == 1, cls
    assert counts["current"] == cq.equity_counts(29, dead, hm, vm,
                                                 n).tolist()
    assert counts["current"] != counts["ms16"]
    # the stubs count another function
    assert counts["no_eval"] != counts["current"]
    assert torch.equal(kv.variant_words("fallback_word", 29, 5, 100, "cpu"),
                       cq.equity_words(29, 6, 5, 100, "cpu"))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    dead, hm, vm = cq._hand_masks(AKS, QQ, (), "cpu")
    with pytest.raises(ValueError):
        kv.variant_counts("nope", 0, dead, hm, vm, 16)
    with pytest.raises(ValueError):
        kv.variant_counts("current", 0, dead, hm, vm, 16,
                          words=torch.zeros((3, 16), dtype=torch.int64))
    with pytest.raises(ValueError):
        kv.variant_counts("current", 0, dead, hm, vm, 16,
                          words=torch.zeros((5, 16), dtype=torch.int64),
                          tile=(512, 16))
    with pytest.raises(ValueError):
        kv.variant_counts("current", 0, dead, hm, vm, 16, tile=(100, 16))
    flop = cq._hand_masks(AKS, QQ, [5, 6, 7], "cpu")
    with pytest.raises(ValueError):
        kv.variant_counts("current", 0, *flop, 16)
    assert kv.parse_tile("512x8") == (512, 8)
    with pytest.raises(ValueError):
        kv.parse_tile("300x8")


HARNESS = r"""
#include <cstdio>
#include <vector>

#include "probe_k1.cuh"

// in = variant, seed, start, n, inject, 4 dead, 4 + 4 masks, then with
// inject the words [K, n]; out = wins, ties; then mode 1 the grid of
// (n, threads, waves, wave) tuples.
template <int V>
static void run(const int* in, std::vector<long long>& out) {
  uint32_t seed = in[1];
  long long start = (uint32_t)in[2];
  int n = in[3];
  const int* words = in[4] ? in + 17 : nullptr;
  MCK1Params p;
  mc_make_deck(in + 5, 4, &p.deck);
  for (int i = 0; i < 8; ++i) p.dead[i] = i < 4 ? in[5 + i] : 52;
  mc_masks_to_planes(in + 9, p.hero);
  mc_masks_to_planes(in + 13, p.villain);
  uint32_t wins = 0, ties = 0;
  for (long long r = start; r < start + n; ++r) {
    int res = words ? mc_k1_variant_rollout<V, 5, true>(
                          p, p.deck.live, words, n, r - start, seed)
                    : mc_k1_variant_rollout<V, 5, false>(
                          p, p.deck.live, nullptr, n, r, seed);
    wins += res > 0;
    ties += res == 0;
  }
  out.push_back(wins);
  out.push_back(ties);
}

int main(int argc, char** argv) {
  FILE* f = fopen(argv[2], "rb");
  std::vector<int> in;
  int x;
  while (fread(&x, sizeof(int), 1, f) == 1) in.push_back(x);
  fclose(f);
  std::vector<long long> out;
  if (argv[1][0] == 'g') {
    for (size_t i = 0; i + 3 < in.size(); i += 4) {
      long long n = (long long)(uint32_t)in[i] << 8;
      out.push_back(mc_k1_grid(n, in[i + 1], in[i + 2], in[i + 3]));
      out.push_back(in[i + 1] == MC_THREADS && in[i + 2] == MC_EQUITY_WAVES
                        ? mc_rollout_grid(n, 1u, in[i + 3])
                        : -1);
    }
  } else {
    switch (in[0]) {
#define V(i) \
  case i:    \
    run<i>(in.data(), out); \
    break;
      V(0) V(1) V(2) V(3) V(4) V(5) V(6) V(7) V(8) V(9) V(10) V(11)
      default: return 2;
    }
  }
  f = fopen(argv[3], "wb");
  fwrite(out.data(), sizeof(long long), out.size(), f);
  fclose(f);
  return 0;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler to build the device code "
                    "for the CPU")
    d = tmp_path_factory.mktemp("k1_host")
    (d / "harness.cc").write_text(HARNESS)
    exe = d / "harness"
    subprocess.run([cxx, "-std=c++17", "-O2", "-I", str(_build.CSRC),
                    str(d / "harness.cc"), "-o", str(exe)], check=True,
                   capture_output=True, timeout=600)

    def run(mode, ints):
        src, dst = d / f"{mode}.in", d / f"{mode}.out"
        (np.asarray(ints, np.int64) & 0xFFFFFFFF).astype(np.uint32) \
            .view(np.int32).tofile(src)
        subprocess.run([str(exe), mode, str(src), str(dst)], check=True,
                       timeout=600)
        return np.fromfile(dst, np.int64)
    return run


@pytest.mark.parametrize("inject", [False, True])
@pytest.mark.parametrize("variant", kv.VARIANTS)
def test_variant_device_code_equals_plain(harness, variant, inject):
    """Every variant's rollout (mc_k1_variant_rollout) over 3000 rollouts,
    on injected words (2% of them in the top range) or in Philox mode
    from rollout 2^31 - 1000, against the plain variant."""
    n, seed, start = 3000, 0x9E3779B9, (1 << 31) - 1000
    dead, hm, vm = cq._hand_masks(SUITED, OFF, (), "cpu")
    params = [*dead.tolist(), *hm.tolist(), *vm.tolist()]
    if inject:
        words = torch.from_numpy(_words(np.random.default_rng(
            kv.VARIANTS.index(variant)), variant, n))
        got = harness("k1", [kv.VARIANTS.index(variant), 0, 0, n, 1,
                             *params, *words.reshape(-1).tolist()])
        want = kv.variant_counts(variant, 0, dead, hm, vm, n, words=words)
    else:
        got = harness("k1", [kv.VARIANTS.index(variant), seed, start, n, 0,
                             *params])
        want = kv._variant_counts_plain(
            variant, kv.variant_words(variant, seed, start, n, "cpu"),
            params[:4], params[4:8], params[8:])
    assert got.tolist() == want.tolist()


def test_grid_is_k1s_at_k1s_tile(harness):
    """mc_k1_grid at 256 threads x 16 waves is K1's mc_rollout_grid, and
    at every tile keeps a thread's rollouts below 2^32."""
    rows = []
    for n8 in (1, 1000, 1 << 21, (1 << 32) - 1):   # n = n8 << 8
        for threads in kv.THREAD_CHOICES:
            for waves in (1, 16, 64):
                rows += [n8, threads, waves, 132 * 8]
    got = harness("g", rows).reshape(-1, 2)
    for (n8, threads, waves, wave), (blocks, k1) in zip(
            np.asarray(rows).reshape(-1, 4), got):
        n = int(n8) << 8
        assert blocks >= 1 and -(-n // (blocks * threads)) < 1 << 32
        if threads == 256 and waves == 16:
            assert blocks == k1
