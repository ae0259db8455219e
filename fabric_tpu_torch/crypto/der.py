"""Alias of `fabric_tpu_torch.common.der`, under the path the JAX
package's `crypto/der` has: the DER (de)serializers live in the lowest
shared layer, and this module makes
``fabric_tpu_torch.crypto.der is fabric_tpu_torch.common.der``.
"""

import sys as _sys

from fabric_tpu_torch.common import der as _impl

_sys.modules[__name__] = _impl
