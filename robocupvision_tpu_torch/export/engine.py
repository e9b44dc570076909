"""ctypes wrapper for the native C++ inference engine (native/engine.cpp),
the port's own copy of the JAX package's export/engine.py.

Builds librobocup_engine.so on demand (``make -s`` in native/, g++) and
exposes a small API to run cfg + weights.dat artifacts and to read each
layer's output, for the golden-vector checks against ``netcfg.run_cfg``:
the reference's testDumper contract (testDumper.py:58-75), inverted, the
goldens computed here and replayed by the engine. The engine is the
robot's: it runs on the host CPU.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "librobocup_engine.so")

_lib = None


def _build() -> None:
    subprocess.run(["make", "-s"], cwd=_NATIVE_DIR, check=True)


def _load_lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH) or (
            os.path.getmtime(_LIB_PATH)
            < os.path.getmtime(os.path.join(_NATIVE_DIR, "engine.cpp"))):
        _build()
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        # another process may have been writing the library: build once more
        _build()
        lib = ctypes.CDLL(_LIB_PATH)
    lib.rcv_engine_create.restype = ctypes.c_void_p
    lib.rcv_engine_create.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.rcv_engine_destroy.argtypes = [ctypes.c_void_p]
    lib.rcv_engine_input_size.argtypes = [ctypes.c_void_p]
    lib.rcv_engine_input_size.restype = ctypes.c_int
    lib.rcv_engine_layer_count.argtypes = [ctypes.c_void_p]
    lib.rcv_engine_layer_count.restype = ctypes.c_int
    lib.rcv_engine_weights_fully_consumed.argtypes = [ctypes.c_void_p]
    lib.rcv_engine_weights_fully_consumed.restype = ctypes.c_int
    lib.rcv_engine_forward.argtypes = [ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_float),
                                       ctypes.c_int, ctypes.c_int]
    lib.rcv_engine_forward.restype = ctypes.c_int
    lib.rcv_engine_layer_output.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.rcv_engine_layer_output.restype = ctypes.c_int
    _lib = lib
    return lib


class NativeEngine:
    """A loaded cfg + weights.dat network running on the host CPU."""

    def __init__(self, cfg_path: str, weights_path: str):
        self._lib = _load_lib()
        self._h = self._lib.rcv_engine_create(cfg_path.encode(),
                                              weights_path.encode())
        if not self._h:
            raise RuntimeError(f"engine failed to load {cfg_path} + {weights_path}")

    def close(self) -> None:
        if self._h:
            self._lib.rcv_engine_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass

    @property
    def input_size(self) -> int:
        return self._lib.rcv_engine_input_size(self._h)

    @property
    def layer_count(self) -> int:
        return self._lib.rcv_engine_layer_count(self._h)

    @property
    def weights_fully_consumed(self) -> bool:
        return bool(self._lib.rcv_engine_weights_fully_consumed(self._h))

    def forward(self, x_chw: np.ndarray) -> np.ndarray:
        """Run a (C, H, W) float32 input of any spatial size (the networks
        are fully convolutional; the cfg's dims are nominal)."""
        x = np.ascontiguousarray(x_chw, dtype=np.float32)
        n = self._lib.rcv_engine_forward(
            self._h, x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            int(x.shape[1]), int(x.shape[2]))
        if n < 0:
            raise RuntimeError("engine forward failed")
        return self.layer_output(self.layer_count - 1)

    def layer_output(self, i: int) -> np.ndarray:
        dims = (ctypes.c_int * 3)()
        dummy = np.zeros(1, np.float32)
        needed = self._lib.rcv_engine_layer_output(
            self._h, i, dummy.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            0, dims)
        buf = np.empty(needed, np.float32)
        self._lib.rcv_engine_layer_output(
            self._h, i, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            needed, dims)
        return buf.reshape(dims[0], dims[1], dims[2])
