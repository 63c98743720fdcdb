"""The kernels' device code, compiled for the CPU, against the plain versions.

The headers in ``montecarlo_tpu_torch/csrc`` are host C++ as well (``MC_HD``
expands to ``inline`` outside nvcc). A small harness built with the host
C++ compiler runs the kernels' per-thread bodies (one rollout of K1/K2,
one table of K4) in Philox mode, the way the kernels key their streams,
and the results must equal the plain versions fed ``ops/philox.py``'s
words. This checks the device code's arithmetic before it meets a card;
the launch geometry is checked on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``). Skips without a host C++ compiler.
"""

import shutil
import subprocess

import numpy as np
import pytest
import torch

from montecarlo_tpu_torch.engine.state import TableConfig
from montecarlo_tpu_torch.ops import _build
from montecarlo_tpu_torch.ops import cuda_engine as ce
from montecarlo_tpu_torch.ops import cuda_equity as cq
from test_torch_philox import PHILOX_KAT

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

HARNESS = r"""
#include <cstdio>
#include <cstring>
#include <vector>

#include "engine.cuh"
#include "equity.cuh"

typedef std::vector<long long> Out;

static void k1(const int* in, Out& out) {
  uint32_t seed = in[0];
  long long start = ((long long)in[1] << 32) | (uint32_t)in[2];
  int n = in[3];
  MCEquityParams p;
  p.n_dead = in[4];
  for (int i = 0; i < 8; ++i) p.dead[i] = i < p.n_dead ? in[5 + i] : 99;
  for (int s = 0; s < 4; ++s) {
    p.hero[s] = in[5 + p.n_dead + s];
    p.villain[s] = in[9 + p.n_dead + s];
  }
  long long wins = 0, ties = 0;
  for (long long r = start; r < start + n; ++r) {
    MCWords src(nullptr, n, r, seed, (uint32_t)r, (uint32_t)(r >> 32), 0u);
    int res = p.n_dead == 4   ? mc_rollout_vs_hand<5>(src, p)
              : p.n_dead == 7 ? mc_rollout_vs_hand<2>(src, p)
                              : mc_rollout_vs_hand<1>(src, p);
    wins += res > 0;
    ties += res == 0;
  }
  out.push_back(wins);
  out.push_back(ties);
}

static void k2(const int* in, Out& out) {
  uint32_t seed = in[0];
  int H = in[1], n = in[2];
  const int* dead = in + 3;
  const int* hmask = dead + 2 * H;
  Out wins(H), ties(H);
  for (int h = 0; h < H; ++h) {
    uint32_t hm[4];
    for (int s = 0; s < 4; ++s) hm[s] = hmask[4 * h + s];
    for (long long r = 0; r < n; ++r) {
      MCWords src(nullptr, (long long)H * n, (long long)h * n + r, seed,
                  (uint32_t)r, (uint32_t)(r >> 32), (uint32_t)h + 1u);
      int res = mc_rollout_vs_random(src, dead + 2 * h, hm);
      wins[h] += res > 0;
      ties[h] += res == 0;
    }
  }
  out.insert(out.end(), wins.begin(), wins.end());
  out.insert(out.end(), ties.begin(), ties.end());
}

// rows: the packed state as [F, T] (row f of table t at f * T + t).
template <int P>
static void k4(const int* in, Out& out) {
  uint32_t seed = in[1];
  int n_steps = in[2], defer = in[3], sb = in[4], bb = in[5];
  uint32_t fold = in[6], raise = in[7];
  int T = in[8];
  const int* rows = in + 9;
  constexpr int F = mc_fields<P>();
  std::vector<int> res((size_t)F * T);
  for (int t = 0; t < T; ++t) {
    MCTable<P> s;
    int* v = reinterpret_cast<int*>(&s);
    for (int f = 0; f < F; ++f) v[f] = rows[(size_t)f * T + t];
    MCWords src(nullptr, T, t, seed, (uint32_t)t, 0u, 0u);
    mc_run_prng(s, src, n_steps, defer, sb, bb, fold, raise);
    for (int f = 0; f < F; ++f) res[(size_t)f * T + t] = v[f];
  }
  out.insert(out.end(), res.begin(), res.end());
}

int main(int argc, char** argv) {
  if (argc != 4) return 2;
  std::vector<int> in;
  FILE* f = fopen(argv[2], "rb");
  int x;
  while (fread(&x, sizeof x, 1, f) == 1) in.push_back(x);
  fclose(f);
  Out out;
  if (!strcmp(argv[1], "kat")) {
    for (size_t i = 0; i + 6 <= in.size(); i += 6) {
      uint32_t c[4] = {(uint32_t)in[i], (uint32_t)in[i + 1],
                       (uint32_t)in[i + 2], (uint32_t)in[i + 3]};
      mc_philox4x32_10(c, in[i + 4], in[i + 5]);
      for (int j = 0; j < 4; ++j) out.push_back(c[j]);
    }
  } else if (!strcmp(argv[1], "k1")) {
    k1(in.data(), out);
  } else if (!strcmp(argv[1], "k2")) {
    k2(in.data(), out);
  } else if (!strcmp(argv[1], "k4") && in[0] == 2) {
    k4<2>(in.data(), out);
  } else if (!strcmp(argv[1], "k4") && in[0] == 6) {
    k4<6>(in.data(), out);
  } else {
    return 2;
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
    d = tmp_path_factory.mktemp("csrc_host")
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


def test_philox_header_known_answers(harness):
    got = harness("kat", [v for ck, _ in PHILOX_KAT for v in ck])
    assert got.reshape(-1, 4).tolist() == [w for _, w in PHILOX_KAT]


@pytest.mark.parametrize("board,start", [
    ((), 0), ((5, 6, 7), (1 << 32) - 1000), ((5, 6, 7, 44), 77)])
def test_equity_rollout_device_code_equals_plain(harness, board, start):
    seed, n = 0x9E3779B9, 3000
    dead, hm, vm = (m.tolist() for m in cq._hand_masks(
        [0, 12], [25, 38], board, "cpu"))
    got = harness("k1", [seed, start >> 32, start & 0xFFFFFFFF, n,
                         len(dead), *dead, *hm, *vm])
    words = cq.equity_words(seed, 9 - len(dead), start, n, "cpu")
    assert got.tolist() == cq._equity_counts_plain(words, dead, hm,
                                                   vm).tolist()


def test_sweep_rollout_device_code_equals_plain(harness):
    heroes = torch.tensor([[0, 13], [5, 40], [12, 51], [20, 21]],
                          dtype=torch.int32)
    dead = torch.sort(heroes, dim=1).values
    hm = torch.stack(cq.suit_masks_from_cards(heroes), dim=1)
    got = harness("k2", [17, 4, 2000, *dead.reshape(-1).tolist(),
                         *hm.reshape(-1).tolist()])
    want = cq._sweep_counts_plain_philox(17, dead, hm, 2000)
    assert got.reshape(2, 4).tolist() == want.tolist()


@pytest.mark.parametrize("P,n_steps", [(6, 64), (2, 24)])
def test_engine_prng_device_code_equals_plain(harness, P, n_steps):
    cfg = TableConfig(num_seats=P)
    T = ce.TABLES_PER_BLOCK
    state = ce.pack_state(cfg, ce.first_deal(3, T, P))
    rows = ce._to_rows(state)
    got = harness("k4", [P, 31, n_steps, ce._defer_for(n_steps), 5, 10,
                         ce.FOLD_P_BITS, ce.RAISE_P_BITS, T,
                         *rows.reshape(-1).tolist()])
    want = ce._to_rows(ce.run_perpetual_prng(31, state, P, n_steps, 5, 10))
    np.testing.assert_array_equal(got.astype(np.int32).reshape(rows.shape),
                                  want.numpy())
    assert int(ce.unpack_field(ce._to_blocks(want), cfg, "hand_ct")
               .sum()) > 0
