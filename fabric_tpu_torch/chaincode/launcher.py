"""Chaincode process entry point (what the built-in python builder runs).

Loads `chaincode.py` from the built source dir, instantiates its
`chaincode` object (or a `Chaincode` class), and serves the shim stream
against the peer (reference: the chaincode binary's main calling
shim.Start).

The port's counterpart of the JAX package's `chaincode/launcher.py`, run by
the port's `chaincode/extbuilder.Launcher` as
`python -m fabric_tpu_torch.chaincode.launcher`. It needs only the shim
stream (`chaincode/extshim`) and imports no torch.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys


def load_chaincode(source_dir: str):
    path = os.path.join(source_dir, "chaincode.py")
    if not os.path.exists(path):
        raise SystemExit(f"no chaincode.py in {source_dir}")
    spec = importlib.util.spec_from_file_location("user_chaincode", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["user_chaincode"] = mod
    spec.loader.exec_module(mod)
    cc = getattr(mod, "chaincode", None)
    if cc is None:
        cls = getattr(mod, "Chaincode", None)
        if cls is None:
            raise SystemExit(
                "chaincode.py must define `chaincode` or class `Chaincode`"
            )
        cc = cls()
    return cc


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="chaincode-launcher")
    parser.add_argument("--source-dir", required=True)
    parser.add_argument("--peer-address", required=True)
    parser.add_argument("--chaincode-id", required=True)
    args = parser.parse_args(argv)

    from fabric_tpu_torch.chaincode import extshim

    cc = load_chaincode(args.source_dir)
    extshim.start(cc, args.peer_address, args.chaincode_id)
    return 0


if __name__ == "__main__":
    sys.exit(main())
