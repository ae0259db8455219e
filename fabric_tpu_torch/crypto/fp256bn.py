"""Alias of `fabric_tpu_torch.common.fp256bn`, under the path the JAX
package's `crypto/fp256bn` has: the FP256BN field and curve oracle live in the lowest
shared layer, and this module makes
``fabric_tpu_torch.crypto.fp256bn is fabric_tpu_torch.common.fp256bn``.
"""

import sys as _sys

from fabric_tpu_torch.common import fp256bn as _impl

_sys.modules[__name__] = _impl
