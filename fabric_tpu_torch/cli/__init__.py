"""Command-line tools of the port (reference cmd/*): `idemixgen`, and the
`version` subcommand the tools share."""

from __future__ import annotations

import os
import platform
import subprocess

import fabric_tpu_torch


def version_cmd(binary: str) -> int:
    """reference `peer version` (cmd/peer/version): tool, framework
    version, commit, runtime; the port's copy of the JAX package's
    `cli/peer._version_cmd`."""
    try:
        commit = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=5,
            cwd=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):  # no git in deployment
        commit = "unknown"
    print(f"{binary}:")
    print(f" Version: {fabric_tpu_torch.__version__}")
    print(f" Commit SHA: {commit or 'unknown'}")
    print(f" Go version: n/a (python {platform.python_version()})")
    print(f" OS/Arch: {platform.system().lower()}/{platform.machine()}")
    return 0
