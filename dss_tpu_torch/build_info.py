"""Build information (the pkg/build analog, info.go:4-25).

The reference injects commit/time/host via `-ldflags -X`; the Python
analog reads DSS_BUILD_* env vars (set by the Dockerfile / CI at image
build) and falls back to asking git at runtime.  Logged at server
startup and exported as an info gauge on /metrics."""

from __future__ import annotations

import os
import socket
import subprocess
import time
from functools import lru_cache


@lru_cache(maxsize=1)
def build_info() -> dict:
    commit = os.environ.get("DSS_BUILD_COMMIT", "")
    built_at = os.environ.get("DSS_BUILD_TIME", "")
    if not commit:
        # dev-checkout fallback only: the .git must sit right next to
        # the package, or `git rev-parse` would walk up and report
        # whatever unrelated repo encloses a pip-installed venv
        pkg_dir = os.path.dirname(os.path.abspath(__file__))
        repo_root = os.path.dirname(pkg_dir)
        if os.path.exists(os.path.join(repo_root, ".git")):  # dir or worktree file
            try:
                commit = subprocess.run(
                    ["git", "-C", repo_root, "rev-parse", "--short", "HEAD"],
                    capture_output=True,
                    text=True,
                    timeout=5,
                ).stdout.strip() or "unknown"
            except (OSError, subprocess.SubprocessError):
                commit = "unknown"
        else:
            commit = "unknown"
    return {
        "commit": commit,
        "build_time": built_at or "unknown",
        "host": socket.gethostname(),
        "started_at": time.strftime(
            "%Y-%m-%dT%H:%M:%SZ", time.gmtime()
        ),
    }
