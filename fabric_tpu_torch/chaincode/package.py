"""Chaincode packaging + installed-package store (reference
`peer lifecycle chaincode package` / `install`: core/chaincode/persistence
+ lifecycle.go InstallChaincode, ChaincodePackageLocator).

Package layout mirrors the reference's lifecycle tgz:

  <label>.tar.gz
  ├── metadata.json    {"type": "python", "label": "<label>"}
  └── code.tar.gz      the chaincode source tree

package_id = "<label>:<sha256-hex of the package bytes>" — identical
derivation to the reference (persistence/chaincode_package.go).

The port's counterpart of the JAX package's `chaincode/package.py`: the same
package bytes and ids.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import tarfile
from dataclasses import dataclass
from typing import Dict, List, Tuple


class PackageError(ValueError):
    pass


def package(
    label: str,
    code_files: Dict[str, bytes],
    cc_type: str = "python",
    path: str = "",
) -> bytes:
    """Build a chaincode package from {relative path: bytes}. `path`
    lands in metadata.json like the reference's platform path field
    (persistence/chaincode_package.go ChaincodePackageMetadata)."""
    if not label or any(c in label for c in ":/\\"):
        raise PackageError(f"invalid label {label!r}")
    code_buf = io.BytesIO()
    with tarfile.open(fileobj=code_buf, mode="w:gz") as tar:
        for name in sorted(code_files):
            data = code_files[name]
            info = tarfile.TarInfo(name)
            info.size = len(data)
            info.mtime = 0  # deterministic package bytes
            tar.addfile(info, io.BytesIO(data))
    meta_dict = {"type": cc_type, "label": label}
    if path:
        meta_dict["path"] = path
    meta = json.dumps(meta_dict, sort_keys=True).encode()

    out = io.BytesIO()
    with tarfile.open(fileobj=out, mode="w:gz") as tar:
        for name, data in (
            ("metadata.json", meta),
            ("code.tar.gz", code_buf.getvalue()),
        ):
            info = tarfile.TarInfo(name)
            info.size = len(data)
            info.mtime = 0
            tar.addfile(info, io.BytesIO(data))
    return out.getvalue()


def parse_package(raw: bytes) -> Tuple[dict, Dict[str, bytes]]:
    """Package bytes -> (metadata dict, {path: bytes} of the code tree)."""
    try:
        with tarfile.open(fileobj=io.BytesIO(raw), mode="r:gz") as tar:
            names = tar.getnames()
            if "metadata.json" not in names or "code.tar.gz" not in names:
                raise PackageError(
                    f"package must contain metadata.json + code.tar.gz, got {names}"
                )
            meta = json.loads(tar.extractfile("metadata.json").read())
            code_raw = tar.extractfile("code.tar.gz").read()
        files: Dict[str, bytes] = {}
        with tarfile.open(fileobj=io.BytesIO(code_raw), mode="r:gz") as tar:
            for member in tar.getmembers():
                if not member.isfile():
                    continue
                if member.name.startswith(("/", "..")):
                    raise PackageError(f"unsafe path {member.name!r}")
                files[member.name] = tar.extractfile(member).read()
    except (tarfile.TarError, json.JSONDecodeError, KeyError) as e:
        raise PackageError(f"malformed chaincode package: {e}") from e
    if "label" not in meta:
        raise PackageError("metadata.json missing label")
    return meta, files


def package_id(raw: bytes) -> str:
    meta, _files = parse_package(raw)
    return f"{meta['label']}:{hashlib.sha256(raw).hexdigest()}"


@dataclass
class InstalledPackage:
    package_id: str
    label: str
    cc_type: str
    path: str


class PackageStore:
    """Installed chaincodes on the peer's filesystem (reference
    core/chaincode/persistence Store: <ski>/<packageid>.tar.gz)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, pid: str) -> str:
        return os.path.join(self.root, pid.replace(":", ".") + ".tar.gz")

    def install(self, raw: bytes) -> InstalledPackage:
        meta, _files = parse_package(raw)
        pid = package_id(raw)
        path = self._path(pid)
        if not os.path.exists(path):
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(raw)
            os.replace(tmp, path)
        return InstalledPackage(pid, meta["label"], meta.get("type", "python"), path)

    def load(self, pid: str) -> bytes:
        path = self._path(pid)
        if not os.path.exists(path):
            raise PackageError(f"package {pid} is not installed")
        with open(path, "rb") as f:
            return f.read()

    def list_installed(self) -> List[InstalledPackage]:
        out = []
        for name in sorted(os.listdir(self.root)):
            if not name.endswith(".tar.gz"):
                continue
            pid = name[: -len(".tar.gz")]
            # filename uses '.' for ':' — recover label:hash
            label, _, digest = pid.rpartition(".")
            with open(os.path.join(self.root, name), "rb") as f:
                raw = f.read()
            meta, _ = parse_package(raw)
            out.append(
                InstalledPackage(
                    f"{label}:{digest}",
                    meta["label"],
                    meta.get("type", "python"),
                    os.path.join(self.root, name),
                )
            )
        return out
