"""ctypes bindings to the native host runtime (``native/mcpoker.cpp``).

The port's own loader, a copy of ``montecarlo_tpu/native.py``'s bindings:
the single-table C++ engine serves the server's latency path
(interactive actions in microseconds), the batch evaluators the tests.

The build differs from the JAX package's, which runs ``make -B`` inside
``native/``: here ``g++`` compiles ``native/mcpoker.cpp`` into
``montecarlo_tpu_torch/_build/native/<hash of the source>/libmcpoker.so``
and nothing is written under ``native/``. The build holds an ``fcntl``
lock and writes a temporary file that ``os.replace`` puts in place, so
processes that load at once (pytest workers) build once between them.
The flags are ``native/Makefile``'s without ``-march=native``: the build
directory may travel with a copy of the tree to another machine, and the
library must run on whichever CPU loads it.

``available()`` is False only where no C++ compiler exists; a build that
fails where one exists raises.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

PKG = Path(__file__).resolve().parent
SOURCE = PKG.parent / "native" / "mcpoker.cpp"
BUILD = PKG / "_build" / "native"
LIB_NAME = "libmcpoker.so"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared"]

_I32P = ctypes.POINTER(ctypes.c_int32)
_U32P = ctypes.POINTER(ctypes.c_uint32)
# C entry -> (restype, argtypes)
SIGNATURES = {
    "mc_eval7": (ctypes.c_uint32, [_I32P]),
    "mc_eval5": (ctypes.c_uint32, [_I32P]),
    "mc_eval7_batch": (None, [_I32P, ctypes.c_int64, _U32P]),
    "mc_eval7_cmp": (ctypes.c_uint32, [_I32P]),
    "mc_eval7_cmp_batch": (None, [_I32P, ctypes.c_int64, _U32P]),
    "mc_table_new": (ctypes.c_void_p, [ctypes.c_int32, ctypes.c_int32,
                                       ctypes.c_int32, _I32P, _I32P]),
    "mc_table_free": (None, [ctypes.c_void_p]),
    "mc_table_clamp": (ctypes.c_int32, [ctypes.c_void_p, ctypes.c_int32]),
    "mc_table_act": (None, [ctypes.c_void_p, ctypes.c_int32]),
    "mc_table_act_raw": (None, [ctypes.c_void_p, ctypes.c_int32]),
    "mc_table_settle": (None, [ctypes.c_void_p]),
    "mc_table_set_stacks": (None, [ctypes.c_void_p, _I32P]),
    "mc_table_snapshot": (ctypes.c_int32, [ctypes.c_void_p, _I32P,
                                           ctypes.c_int32]),
}

_lib = None


def compiler() -> Optional[str]:
    """The host C++ compiler (``$CXX``, else g++ or c++), or None."""
    for name in (os.environ.get("CXX"), "g++", "c++"):
        if name and shutil.which(name):
            return shutil.which(name)
    return None


def library_path() -> Path:
    """Where the library of the checkout's ``mcpoker.cpp`` lies."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD / digest[:16] / LIB_NAME


def build() -> Path:
    """Build the library once (under a lock) and return its path."""
    lib = library_path()
    if lib.exists():
        return lib
    cxx = compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler: set CXX or install g++")
    lib.parent.mkdir(parents=True, exist_ok=True)
    with open(lib.parent / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib.exists():
            tmp = lib.with_name(f".{LIB_NAME}.{os.getpid()}")
            res = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o",
                                  str(tmp)], capture_output=True,
                                 text=True, timeout=600)
            if res.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"building {SOURCE.name} failed:\n"
                                   f"{res.stderr}")
            os.replace(tmp, lib)
    return lib


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    _lib = lib
    return lib


def available() -> bool:
    """True where a C++ compiler exists (the library is then built, and a
    failed build raises)."""
    if compiler() is None and not library_path().exists():
        return False
    _load()
    return True


def _i32(arr) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(arr, dtype=np.int32))


def _ptr(a: np.ndarray, kind=_I32P):
    return a.ctypes.data_as(kind)


def eval7(cards: Sequence[int]) -> int:
    a = _i32(cards)
    assert a.shape == (7,)
    return int(_load().mc_eval7(_ptr(a)))


def _batch(fn_name: str, cards) -> np.ndarray:
    a = _i32(cards)
    assert a.ndim == 2 and a.shape[1] == 7
    out = np.empty((a.shape[0],), dtype=np.uint32)
    getattr(_load(), fn_name)(_ptr(a), a.shape[0], _ptr(out, _U32P))
    return out


def eval7_batch(cards) -> np.ndarray:
    """Packed keys of [N, 7] card ids (uint32 [N])."""
    return _batch("mc_eval7_batch", cards)


def eval7_cmp_batch(cards) -> np.ndarray:
    """Comparison-only keys (C++ twin of ``eval_masks_cmp_impl``)."""
    return _batch("mc_eval7_cmp_batch", cards)


class NativeTable:
    """Single interactive table on the native engine (seat == hand-order
    position; the server maps seats to player ids)."""

    def __init__(self, n: int, small: int, big: int, deck: Sequence[int],
                 stacks: Optional[Sequence[int]] = None):
        self._lib = _load()
        d = _i32(deck)
        assert d.shape == (52,)
        s = _i32(stacks) if stacks is not None else None
        self._ptr = self._lib.mc_table_new(
            n, small, big, _ptr(d), _ptr(s) if s is not None else None)
        if not self._ptr:
            raise ValueError("invalid table configuration")
        self.n = n

    def __del__(self):
        if getattr(self, "_ptr", None):
            self._lib.mc_table_free(self._ptr)
            self._ptr = None

    def clamp(self, action: int) -> int:
        return int(self._lib.mc_table_clamp(self._ptr, action))

    def act(self, action: int, validate: bool = True):
        if validate:
            self._lib.mc_table_act(self._ptr, action)
        else:
            self._lib.mc_table_act_raw(self._ptr, action)

    def settle(self):
        self._lib.mc_table_settle(self._ptr)

    def set_stacks(self, stacks: Sequence[int]):
        """Overwrite live spendable stacks (hand-order space): the global
        per-player stack-ref semantics of database.clj:8-12."""
        s = _i32(stacks)
        assert s.shape == (self.n,)
        self._lib.mc_table_set_stacks(self._ptr, _ptr(s))

    def snapshot(self) -> dict:
        buf = np.zeros((4096,), dtype=np.int32)
        k = self._lib.mc_table_snapshot(self._ptr, _ptr(buf), buf.shape[0])
        assert k > 0
        v = buf[:k].tolist()
        n = v[0]
        i = 8
        stacks = v[i:i + n]
        i += n
        layer_lists = []
        for _ in range(2):  # bets, then pots
            count = v[i]
            i += 1
            layers = []
            for _ in range(count):
                amt, mem, orig, cnt = v[i:i + 4]
                i += 4
                layers.append((amt, _mask_set(mem, n), _mask_set(orig, n),
                               cnt))
            layer_lists.append(layers)
        cursor = v[i]
        n_order = v[i + 1]
        order = v[i + 2:i + 2 + n_order]
        return {
            "stage": v[1], "time": v[2], "n_revealed": v[3],
            "over": bool(v[4]), "head": None if v[5] < 0 else v[5],
            "in_hand": _mask_set(v[6], n), "remaining": _mask_set(v[7], n),
            "stacks": stacks, "bets": layer_lists[0],
            "pots": layer_lists[1], "cursor": cursor, "order": order,
        }


def _mask_set(mask: int, n: int) -> frozenset:
    return frozenset(s for s in range(n) if (mask >> s) & 1)
