"""Stdlib-only build + freshness logic for the port's native host library.

The port's copy of the reference's `dss_tpu/native/_buildlib.py`, with
one difference of place: the sources stay in this package, and the
library and its digest sidecar are written to `build/native/` beside
the package (gitignored), never into the package directory.

    python dss_tpu_torch/native/_buildlib.py [<build dir>]

Freshness is CONTENT-based, not mtime-based: a successful build writes
`<lib>.sha` holding the sha256 of the sources, and the loader accepts
the library only when that digest matches the sources on disk (pip
stamps installed files with their extraction time, so an mtime rule
would trust a stale library).  Concurrent processes (pytest-xdist
workers, a server and its warm thread) take an exclusive file lock, so
one g++ runs per digest; the library and then its sidecar land by
atomic rename, so a reader never loads a half-written pair.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess
import sys
import tempfile

# the single source of truth for what goes into the shared library
SOURCE_NAMES = ["covering.cc", "hostquery.cc", "fastwin.cc"]
SO_NAME = "libdss_torch_native.so"
DIGEST_NAME = SO_NAME + ".sha"
LOCK_NAME = SO_NAME + ".lock"
SRC_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(SRC_DIR)), "build", "native"
)


def source_digest(src_dir: str = SRC_DIR) -> str:
    """sha256 over the sources, in SOURCE_NAMES order."""
    h = hashlib.sha256()
    for name in SOURCE_NAMES:
        with open(os.path.join(src_dir, name), "rb") as f:
            h.update(f.read())
        h.update(b"\x00")  # file boundary
    return h.hexdigest()


_fresh_cache: dict = {}  # (src_dir, build_dir) -> (stat signature, verdict)


def _stat_sig(src_dir: str, build_dir: str):
    """(path, mtime_ns, size) of the library, its sidecar and the
    sources: the CACHE key of so_fresh.  Correctness stays content-
    based; the stats only decide when the digest is recomputed."""
    out = []
    for path in [os.path.join(build_dir, SO_NAME),
                 os.path.join(build_dir, DIGEST_NAME),
                 *(os.path.join(src_dir, n) for n in SOURCE_NAMES)]:
        try:
            st = os.stat(path)
            out.append((path, st.st_mtime_ns, st.st_size))
        except OSError:
            out.append((path, None, None))
    return tuple(out)


def so_fresh(src_dir: str = SRC_DIR, build_dir: str = BUILD_DIR) -> bool:
    """True iff the library exists and its sidecar digest matches the
    sources on disk.  Never raises: any unreadable state reads as stale
    (callers fall back to the numpy paths)."""
    key = (src_dir, build_dir)
    sig = _stat_sig(src_dir, build_dir)
    cached = _fresh_cache.get(key)
    if cached is not None and cached[0] == sig:
        return cached[1]
    so = os.path.join(build_dir, SO_NAME)
    sha = os.path.join(build_dir, DIGEST_NAME)
    fresh = False
    if os.path.exists(so) and os.path.exists(sha):
        try:
            with open(sha, "r", encoding="ascii") as f:
                recorded = f.read().strip()
            fresh = recorded == source_digest(src_dir)
        except (OSError, UnicodeDecodeError, ValueError):
            fresh = False
    _fresh_cache[key] = (sig, fresh)
    return fresh


def build(src_dir: str = SRC_DIR, build_dir: str = BUILD_DIR,
          timeout: float = 180) -> bool:
    """Compile the sources -> the library + digest sidecar, once per
    digest across processes (file lock), by atomic renames (the sidecar
    lands only after the library it describes)."""
    tmp = None
    try:
        os.makedirs(build_dir, exist_ok=True)
        with open(os.path.join(build_dir, LOCK_NAME), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            _fresh_cache.pop((src_dir, build_dir), None)
            if so_fresh(src_dir, build_dir):
                return True  # a sibling process built it while we waited
            digest = source_digest(src_dir)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
            os.close(fd)
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-o", tmp]
                + [os.path.join(src_dir, n) for n in SOURCE_NAMES],
                check=True,
                capture_output=True,
                timeout=timeout,
            )
            os.replace(tmp, os.path.join(build_dir, SO_NAME))
            tmp = None
            fd, tmp = tempfile.mkstemp(suffix=".sha", dir=build_dir)
            with os.fdopen(fd, "w", encoding="ascii") as f:
                f.write(digest + "\n")
            os.replace(tmp, os.path.join(build_dir, DIGEST_NAME))
            tmp = None
            _fresh_cache.pop((src_dir, build_dir), None)
            return True
    except Exception as e:
        # surface compiler diagnostics
        err = getattr(e, "stderr", None)
        if err:
            sys.stderr.write(
                err.decode("utf-8", "replace")
                if isinstance(err, bytes) else str(err)
            )
        if tmp is not None:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        return False


if __name__ == "__main__":
    d = sys.argv[1] if len(sys.argv) > 1 else BUILD_DIR
    if not build(SRC_DIR, d):
        sys.exit("native library build failed")
    print(f"built {os.path.join(d, SO_NAME)}")
