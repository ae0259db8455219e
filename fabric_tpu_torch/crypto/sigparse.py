"""Batch DER signature parsing for the device feed (host code).

The port's counterpart of the JAX package's `utils/native.batch_der_parse`:
`batch_der_parse` runs the native library's `fn_batch_der_parse`
(`utils/native.py`), and `batch_der_parse_python`, the JAX module's Python
branch, is the plain version the tests hold it to.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from fabric_tpu_torch.common import der, p256
from fabric_tpu_torch.utils.native import batch_der_parse  # noqa: F401  (the native route)


def batch_der_parse_python(
    sigs: Sequence[bytes],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(r[N,32], s[N,32], ok[N], low_s[N]) as uint8 arrays.

    r and s are big-endian. ok=0 for malformed DER or for r, s outside
    [1, n); those rows keep r = s = 0. low_s mirrors IsLowS (s <= n/2).
    """
    n = len(sigs)
    r = np.zeros((n, 32), dtype=np.uint8)
    s = np.zeros((n, 32), dtype=np.uint8)
    ok = np.zeros(n, dtype=np.uint8)
    low_s = np.zeros(n, dtype=np.uint8)
    for i, sig in enumerate(sigs):
        try:
            ri, si = der.unmarshal_signature(sig)
        except der.DerError:
            continue
        if not (1 <= ri < p256.N and 1 <= si < p256.N):
            continue
        ok[i] = 1
        low_s[i] = 1 if p256.is_low_s(si) else 0
        r[i] = np.frombuffer(ri.to_bytes(32, "big"), dtype=np.uint8)
        s[i] = np.frombuffer(si.to_bytes(32, "big"), dtype=np.uint8)
    return r, s, ok, low_s
