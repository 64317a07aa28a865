"""Compile-on-first-use machinery for the shared native C++ runtime.

The port compiles the repository's ``<checkout>/native/*.cpp`` sources
as they stand, read-only, into its own build directory
(``dint_tpu_torch/_build/``, or ``DINT_TPU_TORCH_BUILD_DIR``).  It never
writes into ``native/``: the reference package builds its binaries
there, and the two packages must not clobber each other's shared
objects.

Builds are safe under concurrent processes: the compiler writes to a
temp file that is atomically renamed into place, and an exclusive
``flock`` serializes rebuilds — no process ever ``dlopen``s a
half-written shared object.  A binary is fresh only if its recorded
source hash matches the sources.
"""

from __future__ import annotations

import contextlib
import fcntl
import hashlib
import os
import subprocess
import sys
import tempfile
from typing import Optional, Sequence

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_ROOT = os.path.dirname(_PKG_ROOT)
NATIVE_DIR = os.path.join(_REPO_ROOT, "native")


def build_dir() -> str:
    """The port's build directory (created on first use)."""
    d = os.environ.get("DINT_TPU_TORCH_BUILD_DIR") or os.path.join(
        _PKG_ROOT, "_build"
    )
    os.makedirs(d, exist_ok=True)
    return d


def source_path(filename: str) -> Optional[str]:
    """Locate a native source file under ``<checkout>/native``, or None
    with a stderr notice."""
    p = os.path.join(NATIVE_DIR, filename)
    if os.path.exists(p):
        return p
    print(
        f"dint_tpu_torch: native source {filename} not found under "
        f"{NATIVE_DIR}",
        file=sys.stderr,
    )
    return None


@contextlib.contextmanager
def locked(path: str):
    fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)


def compile_atomic(cmd: Sequence[str], srcs: Sequence[str], out: str) -> bool:
    """Run ``cmd + [-o tmp]``, rename tmp to ``out`` and record the
    sources' hash; return False (with the compiler's stderr printed) on
    failure.  The caller holds ``locked(out + '.lock')``."""
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=os.path.dirname(out))
    os.close(fd)
    try:
        subprocess.run([*cmd, "-o", tmp], check=True, capture_output=True)
        os.replace(tmp, out)
        with open(out + ".srchash", "w") as f:
            f.write(src_hash(srcs))
        return True
    except subprocess.CalledProcessError as e:
        print(
            f"build of {os.path.basename(out)} failed:\n"
            f"{e.stderr.decode(errors='replace')}",
            file=sys.stderr,
        )
        return False
    except FileNotFoundError as e:
        print(f"build of {os.path.basename(out)} failed: {e}", file=sys.stderr)
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def ensure_so(
    src: str,
    so_name: str,
    extra_args: Sequence[str] = (),
    force: bool = False,
    extra_srcs: Sequence[str] = (),
) -> Optional[str]:
    """Compile ``src`` (+ ``extra_srcs``) with g++ into ``so_name`` in
    the build directory if stale; return the .so path, or None if the
    toolchain fails.  ``force`` rebuilds even when fresh (used by the
    TLS-model fallback retry)."""
    out = os.path.join(build_dir(), so_name)
    srcs = (src, *extra_srcs)
    if not force and fresh(out, srcs):
        return out
    with locked(out + ".lock"):
        if not force and fresh(out, srcs):
            return out
        # -include cstdio: native/dint_encoder.cpp calls fprintf without
        # including <cstdio>, which GCC 13's libstdc++ headers no longer
        # pull in on their own
        cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared",
               "-fPIC", "-include", "cstdio", *extra_args, *srcs]
        return out if compile_atomic(cmd, srcs, out) else None


def src_hash(srcs: Sequence[str]) -> str:
    h = hashlib.sha256()
    for p in srcs:
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def fresh(out: str, srcs: Sequence[str]) -> bool:
    """A binary is fresh only if its recorded source hash matches
    (mtime is not trustworthy across checkouts)."""
    if not os.path.exists(out):
        return False
    try:
        with open(out + ".srchash") as f:
            return f.read().strip() == src_hash(srcs)
    except OSError:
        return False
