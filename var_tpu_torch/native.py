"""The port's native host libraries, loaded through ctypes (the counterpart
of var_tpu/native/__init__.py).

    simcore  csrc/simcore.cpp  the grid sim's raycast frame, rotate_crop
    shmbuf   csrc/shmbuf.cpp   POSIX shared memory for ShmemVecEnv

Each is compiled with g++ at first use into build/native/, with the JAX
loader's flags exactly (-O3 -shared -fPIC: no -march=native, no fast-math,
so the compiler contracts no a*b+c into an FMA and the frame's bytes are
those of the JAX package's library). The compiler writes a temporary file
that os.replace then puts in place, so processes that build at once never
load half a library.

A failed build raises with the compiler's output: nothing drops to numpy
or to mp.Array in its place. VAR_TPU_NO_NATIVE (the JAX package's switch)
is the one way to ask for the numpy render: `simcore()` then returns None.
It leaves the transport alone; ShmemVecEnv takes transport='array' by name.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "native"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_libs: dict = {}


def build(name: str, force: bool = False) -> Path:
    """Compile csrc/<name>.cpp into build/native/lib<name>.so unless an
    up-to-date one exists; returns its path. Raises RuntimeError with the
    compiler's output if the build fails."""
    src = CSRC / f"{name}.cpp"
    out = BUILD_DIR / f"lib{name}.so"
    if (not force and out.exists()
            and out.stat().st_mtime >= src.stat().st_mtime):
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [CXX, *CXX_FLAGS, str(src), "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except OSError as e:
        os.unlink(tmp)
        raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load(name: str, bind) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            bind(lib)
            _libs[name] = lib
        return lib


def _bind_simcore(lib):
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.raycast_render.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int,
        f32p, ctypes.c_int, f32p,
        ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_int, ctypes.c_int,
        u8p, u8p, u8p, u8p,
    ]
    lib.raycast_render.restype = None
    lib.rotate_crop.argtypes = [u8p, ctypes.c_int, ctypes.c_float, u8p]
    lib.rotate_crop.restype = None


def _bind_shmbuf(lib):
    lib.shmbuf_create.argtypes = [ctypes.c_char_p, ctypes.c_long]
    lib.shmbuf_create.restype = ctypes.c_int
    lib.shmbuf_open.argtypes = [ctypes.c_char_p]
    lib.shmbuf_open.restype = ctypes.c_int
    lib.shmbuf_map.argtypes = [ctypes.c_int, ctypes.c_long]
    lib.shmbuf_map.restype = ctypes.c_void_p
    lib.shmbuf_unmap.argtypes = [ctypes.c_void_p, ctypes.c_long]
    lib.shmbuf_unmap.restype = ctypes.c_int
    lib.shmbuf_close_fd.argtypes = [ctypes.c_int]
    lib.shmbuf_close_fd.restype = ctypes.c_int
    lib.shmbuf_unlink.argtypes = [ctypes.c_char_p]
    lib.shmbuf_unlink.restype = ctypes.c_int


def simcore():
    """The raycast library, or None where VAR_TPU_NO_NATIVE asks for the
    numpy render."""
    if os.environ.get("VAR_TPU_NO_NATIVE"):
        return None
    return _load("simcore", _bind_simcore)


def shmbuf():
    """The shared-memory library."""
    return _load("shmbuf", _bind_shmbuf)
