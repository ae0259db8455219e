"""External chaincode builders + the subprocess launcher (reference
core/container/externalbuilder: exec out-of-process bin/detect, bin/build
and bin/run with the documented directory arguments; plus the built-in
launcher that runs python chaincode packages as real subprocesses which
dial back into the peer's chaincode listener).

Builder contract (externalbuilder.go):

  <builder>/bin/detect  CHAINCODE_SOURCE_DIR CHAINCODE_METADATA_DIR
  <builder>/bin/build   CHAINCODE_SOURCE_DIR CHAINCODE_METADATA_DIR BUILD_OUTPUT_DIR
  <builder>/bin/run     BUILD_OUTPUT_DIR RUN_METADATA_DIR

detect exits 0 to claim a package; run gets RUN_METADATA_DIR/chaincode.json
with {"chaincode_id", "peer_address"} (the reference's connection info).

The port's counterpart of the JAX package's `chaincode/extbuilder.py`. The
JAX package's built-in python builder (its package's chaincode launcher as
a subprocess) is left out: the port's launcher needs the shim stream over
grpc, which comes with a later slice, so a package that no external
builder claims raises `BuildError`.
"""

from __future__ import annotations

import json
import os
import subprocess
from typing import Dict, List, Optional

from fabric_tpu_torch.chaincode.package import InstalledPackage, parse_package


class BuildError(Exception):
    pass


class ExternalBuilder:
    """One builder directory with bin/{detect,build,run} (reference
    externalbuilder.Detect/Build/Run)."""

    def __init__(self, path: str, name: Optional[str] = None):
        self.path = path
        self.name = name or os.path.basename(path.rstrip("/"))

    def _bin(self, tool: str) -> str:
        return os.path.join(self.path, "bin", tool)

    def _exec(self, tool: str, args: List[str], check: bool) -> bool:
        exe = self._bin(tool)
        if not os.access(exe, os.X_OK):
            if check:
                raise BuildError(f"builder {self.name} lacks bin/{tool}")
            return False
        proc = subprocess.run(
            [exe] + args, capture_output=True, text=True
        )
        if proc.returncode != 0 and check:
            raise BuildError(
                f"{self.name}/bin/{tool} failed rc={proc.returncode}: "
                f"{proc.stderr.strip()}"
            )
        return proc.returncode == 0

    def detect(self, source_dir: str, metadata_dir: str) -> bool:
        return self._exec("detect", [source_dir, metadata_dir], check=False)

    def build(self, source_dir: str, metadata_dir: str, output_dir: str) -> None:
        self._exec("build", [source_dir, metadata_dir, output_dir], check=True)

    def run(self, output_dir: str, run_metadata_dir: str) -> subprocess.Popen:
        exe = self._bin("run")
        if not os.access(exe, os.X_OK):
            raise BuildError(f"builder {self.name} lacks bin/run")
        return subprocess.Popen([exe, output_dir, run_metadata_dir])


class Launcher:
    """Build + run installed packages as real subprocesses (the
    dockercontroller/externalbuilder Router slot in container.go)."""

    def __init__(
        self,
        work_dir: str,
        builders: Optional[List[ExternalBuilder]] = None,
    ):
        self.work_dir = work_dir
        self.builders = list(builders or [])
        self._procs: Dict[str, subprocess.Popen] = {}

    def _dirs(self, pkg: InstalledPackage):
        base = os.path.join(
            self.work_dir, pkg.package_id.replace(":", ".")
        )
        dirs = {
            "source": os.path.join(base, "src"),
            "metadata": os.path.join(base, "metadata"),
            "output": os.path.join(base, "bld"),
            "run_metadata": os.path.join(base, "run"),
        }
        for d in dirs.values():
            os.makedirs(d, exist_ok=True)
        return dirs

    def _materialize(self, pkg: InstalledPackage, dirs) -> dict:
        with open(pkg.path, "rb") as f:
            raw = f.read()
        meta, files = parse_package(raw)
        for rel, data in files.items():
            dest = os.path.join(dirs["source"], rel)
            os.makedirs(os.path.dirname(dest) or dirs["source"], exist_ok=True)
            with open(dest, "wb") as f:
                f.write(data)
        with open(os.path.join(dirs["metadata"], "metadata.json"), "w") as f:
            json.dump(meta, f, sort_keys=True)
        return meta

    def launch(
        self, pkg: InstalledPackage, peer_address: str
    ) -> subprocess.Popen:
        """Build (once) and start the chaincode process; it connects back
        to `peer_address` and REGISTERs as its package-id."""
        existing = self._procs.get(pkg.package_id)
        if existing is not None and existing.poll() is None:
            return existing
        dirs = self._dirs(pkg)
        meta = self._materialize(pkg, dirs)
        with open(
            os.path.join(dirs["run_metadata"], "chaincode.json"), "w"
        ) as f:
            json.dump(
                {"chaincode_id": pkg.package_id, "peer_address": peer_address},
                f,
                sort_keys=True,
            )

        # external builders get first claim (externalbuilder.go detect loop)
        for builder in self.builders:
            if builder.detect(dirs["source"], dirs["metadata"]):
                builder.build(dirs["source"], dirs["metadata"], dirs["output"])
                proc = builder.run(dirs["output"], dirs["run_metadata"])
                self._procs[pkg.package_id] = proc
                return proc

        raise BuildError(
            f"no builder claimed package {pkg.package_id} "
            f"(type {meta.get('type')})"
        )

    def stop(self, package_id: Optional[str] = None) -> None:
        targets = (
            [package_id] if package_id is not None else list(self._procs)
        )
        for pid in targets:
            proc = self._procs.pop(pid, None)
            if proc is not None and proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    proc.kill()

