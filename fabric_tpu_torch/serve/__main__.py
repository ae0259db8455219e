"""``python -m fabric_tpu_torch.serve`` — run the resident validation sidecar."""

import sys

from fabric_tpu_torch.serve.server import main

if __name__ == "__main__":
    sys.exit(main())
