"""Build and load the port's CUDA kernels.

``nvcc`` compiles ``csrc/*.cu`` for ``sm_90a`` into shared libraries with a
plain C interface, which ``ctypes`` loads:

- ``library()``: the kernels that take no seat count (``equity.cu``,
  ``multiway.cu``, ``philox.cu``);
- ``library(P)``: the engine and net kernels (``SEAT_SOURCES``) for seat
  count P only, under each rule set they take (``-DMC_SEATS=P``). A run
  builds the seat counts it uses, not all nine;
- ``carry_library()``: the carry probe (``probe_carry.cu``);
- ``compile_library(...)``: the same nvcc build of any source tree into a
  given directory (``scripts/ab_engine.py`` builds another commit's
  ``csrc/`` with it);
- ``build_probe(probe, variant)``: a probe built once per variant, one
  nvcc with ``-D<define>=<DEFINE>_<VARIANT>`` (``PROBES``): the stage
  probe (``probe_stages.cu``, one stage of the engine's step body), the
  K4 split (``probe_split.cu``, K4 with one piece stubbed), the K6
  split (``probe_net.cu``, K6 with one piece of the net decision
  stubbed) and K1's variants (``probe_k1.cu``, K1 with its sampler, suit
  masks or hand key swapped; ``tiles=True`` adds the block sizes other
  than K1's, ``-D<tiles define>=1``). Its build is the measurement, so
  it is never cached on disk: every call compiles afresh, and reports the
  seconds and ptxas's registers, stack frame and spills of the variant's
  kernel;
  ``probe_library`` keeps a process's builds (``probe_built`` says whether
  it has one), ``build_probes`` compiles several variants at once.

The probes (``PROBE_SOURCES``) stay out of the other libraries, so they add
nothing to the main path's build. A library other than a stage's is built
at first use, from the package's own sources, into
``montecarlo_tpu_torch/_build/<hash of the sources>/<name>/``, so an edited
source rebuilds and an unchanged one loads the cached library. Nothing here
runs at import time.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
LIB_NAME = "libmc_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SEAT_SOURCES = ("engine.cu", "net.cu")
PROBE_SOURCES = ("probe_carry.cu", "probe_stages.cu", "probe_split.cu",
                 "probe_net.cu", "probe_k1.cu")
STAGES = ("carry", "policy", "street", "deal", "settle", "full")
SPLITS = ("full", "stub_settle", "stub_eval", "stub_deal", "stub_policy",
          "stub_street", "settle_copy", "street_copy")
NET_SPLITS = ("full", "stub_gumbel", "stub_feat_eval", "stub_features",
              "stub_net", "feat_copy")
# K1's variants, in the order of scripts/bench_kernel_variants.py's table.
K1_VARIANTS = ("current", "ms16", "ms16_packed", "old_packed", "ms16_noeval",
               "old_sampler", "two_noreject", "fallback_word", "ref_eval",
               "old_sampler_ref_eval", "no_eval", "one_eval")
MIN_SEATS, MAX_SEATS = 2, 10

P_ = ctypes.c_void_p
I_ = ctypes.c_int
U_ = ctypes.c_uint
LL_ = ctypes.c_longlong
ULL_ = ctypes.c_ulonglong

# C entry -> argument types (pointers as c_void_p so ctypes never cuts
# them to 32 bits), for the library without and with a seat count. Every
# entry returns its cudaGetLastError() as int.
SIGNATURES = {
    "mc_equity_counts": [I_, P_, I_, LL_, P_, P_, P_],
    "mc_sweep_counts": [I_, P_, P_, I_, LL_, P_, P_, P_],
    "mc_sweep_grid": [I_, LL_, I_, P_],
    "mc_multiway_shares": [I_, P_, I_, P_, I_, LL_, P_, P_, P_],
    "mc_philox_blocks": [P_, P_, I_, P_],
}
SEAT_SIGNATURES = {
    "mc_engine_det": [P_, P_, P_, I_, I_, I_, I_, I_, I_, I_, P_],
    "mc_engine_prng": [P_, I_, P_, I_, I_, I_, I_, I_, I_, I_, I_, I_, P_],
    "mc_first_state": [P_, U_, LL_, I_, I_, I_, I_, I_, I_, P_],
    "mc_net_det": [P_, P_, P_, I_, I_, I_, I_, I_, I_, I_, I_, ULL_, P_],
    "mc_net_eval": [P_, I_, P_, P_, I_, I_, I_, I_, I_, I_, I_, I_, I_, I_,
                    I_, I_, I_, I_, ULL_, P_, P_],
    "mc_net_probe": [P_, P_, P_, P_, I_, I_, I_, I_, P_],
    "mc_net_occupancy": [I_, I_, I_, I_, P_],
}
CARRY_SIGNATURES = {"mc_probe_carry": [I_, I_, P_, P_, I_, I_, P_]}
STAGE_SIGNATURES = {
    "mc_probe_stage": [P_, I_, P_, I_, I_, I_, I_, I_, I_, I_, P_],
    "mc_probe_stage_id": [],
}
SPLIT_SIGNATURES = {
    "mc_probe_split": [P_, I_, I_, I_, I_, I_, I_, I_, I_, I_, P_],
    "mc_probe_split_id": [],
}
NET_SPLIT_SIGNATURES = {
    "mc_probe_net_split": [P_, I_, P_, P_, I_, I_, I_, I_, I_, I_, I_, I_, I_,
                           I_, I_, I_, I_, ULL_, P_, P_],
    "mc_probe_net_split_id": [],
}
K1_SIGNATURES = {
    "mc_probe_k1": [I_, P_, I_, LL_, P_, I_, I_, P_, P_, P_],
    "mc_probe_k1_grid": [LL_, I_, I_, I_, P_],
    "mc_probe_k1_id": [],
}


@dataclasses.dataclass(frozen=True)
class Probe:
    """A probe built once per variant: its source, the define that picks
    the variant (``-D<define>=<define>_<VARIANT>``), the variants in the
    order of their ids, the C entries, what marks its measured kernel in
    the ptxas report (every part of the mangled name), and the define of
    its tile build (``-D<tiles>=1``: more launch shapes), if it has one."""
    source: str
    define: str
    variants: tuple
    signatures: dict
    kernel: tuple
    tiles: str | None = None


# The stage probe's measured kernel is its Philox instantiation (INJECT
# false); the splits build one kernel each; K1's variants K1's launch
# shape (Philox, 256 threads a block).
PROBES = {
    "stage": Probe("probe_stages.cu", "MC_STAGE", STAGES, STAGE_SIGNATURES,
                   ("mc_stage_kernel", "Lb0E")),
    "split": Probe("probe_split.cu", "MC_SPLIT", SPLITS, SPLIT_SIGNATURES,
                   ("mc_split_kernel",)),
    "net_split": Probe("probe_net.cu", "MC_NET_SPLIT", NET_SPLITS,
                       NET_SPLIT_SIGNATURES, ("mc_split_net_kernel",)),
    "k1": Probe("probe_k1.cu", "MC_K1_VARIANT", K1_VARIANTS, K1_SIGNATURES,
                ("mc_k1_variant_kernel", "Lb0ELi256E"), "MC_K1_TILES"),
}


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin/nvcc``, else the one on ``PATH``;
    raise when neither exists."""
    home = os.environ.get("CUDA_HOME")
    if home and os.access(Path(home) / "bin" / "nvcc", os.X_OK):
        return str(Path(home) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        return on_path
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def sources_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _check_seats(seats):
    if not MIN_SEATS <= seats <= MAX_SEATS:
        raise ValueError(f"seats={seats}: expected {MIN_SEATS}..{MAX_SEATS}")


def _sources(seats):
    seat = [CSRC / name for name in SEAT_SOURCES]
    if seats is not None:
        _check_seats(seats)
        return seat, [f"-DMC_SEATS={seats}"]
    probe = [CSRC / name for name in PROBE_SOURCES]
    return [f for f in sorted(CSRC.glob("*.cu"))
            if f not in seat and f not in probe], []


def build(seats: int | None = None) -> tuple[Path, float]:
    """Compile a library unless a build of these sources exists: the one
    without a seat count (``seats`` None) or the one for ``seats``.

    Returns (library path, seconds spent compiling; 0.0 when cached). One
    nvcc runs per source, all at once. The ptxas report (registers, stack,
    spills per kernel) lands beside the library in ``build.log``."""
    sources, defines = _sources(seats)
    return _build_cached(sources, defines, "common" if seats is None
                         else f"p{seats}")


def _build_cached(sources, defines, name):
    out_dir = BUILD / sources_hash() / name
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib, 0.0
    return compile_library(sources, defines, out_dir, CSRC)


def compile_library(sources, defines, out_dir: Path,
                    include: Path) -> tuple[Path, float]:
    """Compile ``sources`` (one nvcc each, all at once, ``-I include``) and
    link them into ``out_dir/libmc_kernels.so``, with ``build.log`` (the
    ptxas report) beside it. Returns (library path, seconds)."""
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / LIB_NAME
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs, procs = [], []
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *defines, "-I", str(include), "-c",
                 str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        outs = [(src, p.communicate()[0], p.returncode) for src, p in procs]
        for src, out, rc in outs:
            if rc != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
        log = [f"== {src.name} {' '.join(defines)}\n{out}"
               for src, out, _ in outs]
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp_lib),
             *map(str, objs)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stderr}")
        (out_dir / "build.log").write_text("\n".join(log))
        os.replace(tmp_lib, lib)  # atomic: two concurrent builds both succeed
    return lib, time.perf_counter() - t0


def load_library(lib_path, signatures) -> ctypes.CDLL:
    """Load a library, its C entries given their argument types
    (``SIGNATURES``, ``SEAT_SIGNATURES``, ...)."""
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def library(seats: int | None = None) -> ctypes.CDLL:
    """The loaded library without a seat count, or the one for ``seats``;
    built on first call."""
    return load_library(build(seats)[0], SIGNATURES if seats is None
                 else SEAT_SIGNATURES)


def carry_library_path() -> Path:
    """The carry probe library (``probe_carry.cu``), built unless a build
    of these sources exists."""
    return _build_cached([CSRC / "probe_carry.cu"], [], "probe_carry")[0]


@functools.lru_cache(maxsize=None)
def carry_library() -> ctypes.CDLL:
    """The loaded carry probe library; built on first call."""
    return load_library(carry_library_path(), CARRY_SIGNATURES)


@dataclasses.dataclass(frozen=True)
class ProbeBuild:
    """One variant's build: the loaded library, nvcc's wall seconds, and
    ptxas's report of the variant's kernel (``ptxas_report``)."""
    variant: str
    lib: ctypes.CDLL
    seconds: float
    ptxas: dict


def build_probe(probe: str, variant: str, seats: int = 6,
                tiles: bool = False) -> ProbeBuild:
    """Compile probe ``probe`` (a key of ``PROBES``) for ``variant`` and
    ``seats`` (``tiles``: its tile build), afresh: one nvcc (compile and
    link) into a new temporary directory under ``_build/<hash>/<probe>s/``,
    so the seconds are a real compile of that variant alone. Raises when
    nvcc fails, ptxas reports no kernel or the library reports another
    variant."""
    spec = PROBES[probe]
    if variant not in spec.variants:
        raise ValueError(f"{probe} {variant!r}: expected one of "
                         f"{spec.variants}")
    if tiles and spec.tiles is None:
        raise ValueError(f"{probe} has no tile build")
    _check_seats(seats)
    nvcc = find_nvcc()
    parent = BUILD / sources_hash() / f"{probe}s"
    parent.mkdir(parents=True, exist_ok=True)
    out_dir = Path(tempfile.mkdtemp(
        prefix=f"{variant}-p{seats}{'-tiles' if tiles else ''}-",
        dir=parent))
    lib_path = out_dir / LIB_NAME
    t0 = time.perf_counter()
    run = subprocess.run(
        [nvcc, *NVCC_FLAGS, f"-DMC_SEATS={seats}",
         f"-D{spec.define}={spec.define}_{variant.upper()}",
         *([f"-D{spec.tiles}=1"] if tiles else []), "-I", str(CSRC),
         "-shared", str(CSRC / spec.source), "-o", str(lib_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    seconds = time.perf_counter() - t0
    if run.returncode != 0:
        raise RuntimeError(f"nvcc failed on {probe} {variant}:\n{run.stdout}")
    (out_dir / "build.log").write_text(run.stdout)
    report = {k: v for k, v in ptxas_report(run.stdout).items()
              if all(part in k for part in spec.kernel)}
    if len(report) != 1:
        raise RuntimeError(f"{probe} {variant}: expected one kernel in the "
                           f"ptxas report, got {sorted(report)}")
    lib = load_library(lib_path, spec.signatures)
    built = getattr(lib, f"mc_probe_{probe}_id")()
    if built != spec.variants.index(variant):
        raise RuntimeError(f"{probe} {variant}: the library reports variant "
                           f"{built}")
    return ProbeBuild(variant, lib, seconds, next(iter(report.values())))


# The probes' builds made in this process, by (probe, variant, seats,
# tiles).
_PROBE_BUILDS: dict = {}


def probe_library(probe: str, variant: str, seats: int = 6,
                  fresh: bool = False, tiles: bool = False) -> ProbeBuild:
    """The ``ProbeBuild`` of ``variant`` of ``probe`` at ``seats`` (its
    tile build when ``tiles``): built (nvcc, afresh) on the first call or
    when ``fresh``, else the build made before in this process."""
    key = (probe, variant, seats, tiles)
    if fresh or key not in _PROBE_BUILDS:
        _PROBE_BUILDS[key] = build_probe(probe, variant, seats, tiles)
    return _PROBE_BUILDS[key]


def probe_built(probe: str, variant: str, seats: int = 6,
                tiles: bool = False) -> bool:
    """Whether this process has built ``variant`` of ``probe`` at
    ``seats`` (its tile build when ``tiles``)."""
    return (probe, variant, seats, tiles) in _PROBE_BUILDS


def build_probes(probe: str, variants, seats: int = 6,
                 workers: int | None = None, tiles=()) -> dict:
    """``probe_library(..., fresh=True)`` of each of ``variants``, and the
    tile build of each of ``tiles``, one nvcc each, ``workers`` at a time
    (all at once by default): variant -> ``ProbeBuild`` of ``variants``."""
    jobs = [(v, False) for v in variants] + [(v, True) for v in tiles]
    with ThreadPoolExecutor(workers or len(jobs)) as pool:
        builds = list(pool.map(lambda j: probe_library(
            probe, j[0], seats, fresh=True, tiles=j[1]), jobs))
    return dict(zip(variants, builds))


_STACK = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")


def ptxas_report(log: str) -> dict:
    """Per kernel (mangled name) in ``nvcc -Xptxas -v`` output: registers,
    stack frame bytes, spill store and spill load bytes. Functions that
    ptxas did not report registers for (device functions) are left out."""
    report, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = _STACK.search(line)
        if m and name:
            report.setdefault(name, {}).update(zip(
                ("stack", "spill_stores", "spill_loads"),
                map(int, m.groups())))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            report.setdefault(name, {})["registers"] = int(m.group(1))
    return {k: v for k, v in report.items() if "registers" in v}


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_ptr(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a pointer."""
    return torch.cuda.current_stream(device).cuda_stream
