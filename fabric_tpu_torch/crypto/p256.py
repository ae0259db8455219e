"""Alias of `fabric_tpu_torch.common.p256`, under the path the JAX
package's `crypto/p256` has: the P-256 host oracle live in the lowest
shared layer, and this module makes
``fabric_tpu_torch.crypto.p256 is fabric_tpu_torch.common.p256``.
"""

import sys as _sys

from fabric_tpu_torch.common import p256 as _impl

_sys.modules[__name__] = _impl
